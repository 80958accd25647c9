// Native scene-IO runtime: fast parsers for COLMAP binary models
// (images.bin and points3D.bin).
//
// The host-side analog of the reference's native components (the
// reference JIT-builds CUDA/C++ plugins for its hot paths;
// pbr/renderutils/ops.py:23-84): here the hot host path is scene
// ingestion — points3D.bin for Mip-NeRF-360-scale scenes holds millions
// of variable-length records that a pure-Python struct loop parses in
// minutes; this module does it in milliseconds. Built with g++ on first
// use by gi_gs_tpu_torch.native, which falls back to the Python readers.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FileBuf {
  std::vector<unsigned char> data;
  size_t pos = 0;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  fb.data.resize((size_t)n);
  fb.ok = (std::fread(fb.data.data(), 1, (size_t)n, f) == (size_t)n);
  std::fclose(f);
  return fb;
}

template <typename T>
bool take(FileBuf& fb, T* out) {
  if (fb.pos + sizeof(T) > fb.data.size()) return false;
  std::memcpy(out, fb.data.data() + fb.pos, sizeof(T));
  fb.pos += sizeof(T);
  return true;
}

// points3D.bin: u64 count, then per point:
//   u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len,
//   track_len x (u32 image_id, u32 point2d_idx)
PyObject* read_points3d(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  FileBuf fb = read_file(path);
  if (!fb.ok) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot read %s", path);
    return nullptr;
  }
  uint64_t count = 0;
  if (!take(fb, &count)) {
    PyErr_SetString(PyExc_ValueError, "truncated points3D.bin");
    return nullptr;
  }
  std::vector<double> xyz(count * 3);
  std::vector<double> rgb(count * 3);
  std::vector<double> err(count);
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t id;
    double p[3], e;
    unsigned char c[3];
    uint64_t track;
    if (!take(fb, &id) || !take(fb, &p[0]) || !take(fb, &p[1]) ||
        !take(fb, &p[2]) || !take(fb, &c[0]) || !take(fb, &c[1]) ||
        !take(fb, &c[2]) || !take(fb, &e) || !take(fb, &track)) {
      PyErr_SetString(PyExc_ValueError, "truncated points3D.bin record");
      return nullptr;
    }
    fb.pos += track * 8;
    xyz[i * 3 + 0] = p[0];
    xyz[i * 3 + 1] = p[1];
    xyz[i * 3 + 2] = p[2];
    rgb[i * 3 + 0] = c[0];
    rgb[i * 3 + 1] = c[1];
    rgb[i * 3 + 2] = c[2];
    err[i] = e;
  }
  // Return raw bytes; the Python wrapper views them as numpy arrays
  // (avoids a numpy C-API build dependency).
  PyObject* xyz_b = PyBytes_FromStringAndSize(
      (const char*)xyz.data(), (Py_ssize_t)(xyz.size() * sizeof(double)));
  PyObject* rgb_b = PyBytes_FromStringAndSize(
      (const char*)rgb.data(), (Py_ssize_t)(rgb.size() * sizeof(double)));
  PyObject* err_b = PyBytes_FromStringAndSize(
      (const char*)err.data(), (Py_ssize_t)(err.size() * sizeof(double)));
  if (!xyz_b || !rgb_b || !err_b) {
    Py_XDECREF(xyz_b);
    Py_XDECREF(rgb_b);
    Py_XDECREF(err_b);
    return nullptr;
  }
  return Py_BuildValue("(KNNN)", (unsigned long long)count, xyz_b, rgb_b,
                       err_b);
}

// images.bin: u64 count, then per image: i32 id, 4x f64 q, 3x f64 t,
// i32 cam_id, null-terminated name, u64 n2d, n2d x (f64 x, f64 y, u64 id)
PyObject* read_images(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  FileBuf fb = read_file(path);
  if (!fb.ok) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot read %s", path);
    return nullptr;
  }
  uint64_t count = 0;
  if (!take(fb, &count)) {
    PyErr_SetString(PyExc_ValueError, "truncated images.bin");
    return nullptr;
  }
  PyObject* list = PyList_New(0);
  if (!list) return nullptr;
  for (uint64_t i = 0; i < count; ++i) {
    int32_t iid, cam_id;
    double q[4], t[3];
    if (!take(fb, &iid) || !take(fb, &q[0]) || !take(fb, &q[1]) ||
        !take(fb, &q[2]) || !take(fb, &q[3]) || !take(fb, &t[0]) ||
        !take(fb, &t[1]) || !take(fb, &t[2]) || !take(fb, &cam_id)) {
      Py_DECREF(list);
      PyErr_SetString(PyExc_ValueError, "truncated images.bin record");
      return nullptr;
    }
    std::string name;
    while (fb.pos < fb.data.size() && fb.data[fb.pos] != 0) {
      name.push_back((char)fb.data[fb.pos++]);
    }
    ++fb.pos;  // null byte
    uint64_t n2d = 0;
    if (!take(fb, &n2d)) {
      Py_DECREF(list);
      PyErr_SetString(PyExc_ValueError, "truncated images.bin record");
      return nullptr;
    }
    fb.pos += n2d * 24;
    PyObject* rec = Py_BuildValue(
        "{s:i,s:(dddd),s:(ddd),s:i,s:s}", "id", iid, "qvec", q[0], q[1], q[2],
        q[3], "tvec", t[0], t[1], t[2], "camera_id", cam_id, "name",
        name.c_str());
    if (!rec || PyList_Append(list, rec) < 0) {
      Py_XDECREF(rec);
      Py_DECREF(list);
      return nullptr;
    }
    Py_DECREF(rec);
  }
  return list;
}

PyMethodDef methods[] = {
    {"read_points3d", read_points3d, METH_VARARGS,
     "read COLMAP points3D.bin -> (n, xyz_bytes, rgb_bytes, err_bytes)"},
    {"read_images", read_images, METH_VARARGS,
     "read COLMAP images.bin -> list of dicts"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "gigs_native_io",
                      "native COLMAP/scene IO", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_gigs_native_io(void) { return PyModule_Create(&module); }
