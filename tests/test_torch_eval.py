"""The port's evaluation slice against the JAX reference on the CPU:
`latlong_to_cubemap`, the Radiance HDR decoder, LPIPS and its weight
formats, `render_cli --brdf_eval`, `relight_cli`, `relight_eval_cli`,
`normal_eval_cli`, `collect_cli` and the Blender loader at
`--resolution 2`. The same numpy inputs go through both packages."""
import json
import os
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from gi_gs_tpu import config as jax_config
from gi_gs_tpu.cli import collect_cli as jax_collect
from gi_gs_tpu.cli import normal_eval_cli as jax_normal_eval
from gi_gs_tpu.cli import relight_cli as jax_relight
from gi_gs_tpu.cli import relight_eval_cli as jax_relight_eval
from gi_gs_tpu.cli import render_cli as jax_render_cli
from gi_gs_tpu.models import light as jax_light
from gi_gs_tpu.models.gaussians import GaussianParams as JaxParams
from gi_gs_tpu.scene.dataset import load_scene as jax_load_scene
from gi_gs_tpu.train.trainer import TrainState as JaxTrainState
from gi_gs_tpu.utils import checkpoint as jax_ckpt
from gi_gs_tpu.utils import lpips as jax_lpips

from gi_gs_tpu_torch import config
from gi_gs_tpu_torch.cli import (collect_cli, normal_eval_cli, relight_cli,
                                 relight_eval_cli, render_cli)
from gi_gs_tpu_torch.models import light
from gi_gs_tpu_torch.scene.dataset import load_scene
from gi_gs_tpu_torch.utils import lpips as lpips_mod
from gi_gs_tpu_torch.utils.checkpoint import state_from_numpy

from test_io import make_blender_dataset
from test_torch_render import (CAP, gaussian_fields, jax_cfg,
                               shared_lut)  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Light: HDRI decoding and the lat-long -> cube resampling
# ---------------------------------------------------------------------------

def test_latlong_to_cubemap_matches_jax():
    """atol 1e-6 on a smooth HDRI (neighbouring texels differ by < 0.15):
    XLA's f32 arccos and torch's differ by up to one ulp, which moves a
    sample by ~2e-6 of a texel. The image is periodic in longitude and
    varies there, so the seam's wrap is checked too."""
    v, u = np.mgrid[0:24, 0:48] + 0.5
    hdri = np.stack([1.0 + 0.5 * np.sin(2 * np.pi * u / 48 + c)
                     * np.sin(np.pi * v / 24) + 0.2 * np.cos(
                         4 * np.pi * v / 24 + c) for c in range(3)],
                    -1).astype(np.float32)
    for res in (16, 33):
        want = np.asarray(jax_light.latlong_to_cubemap(jnp.asarray(hdri), res))
        got = light.latlong_to_cubemap(torch.as_tensor(hdri), res).numpy()
        assert got.shape == (6, res, res, 3)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_export_envmap_np_matches_jax(as_tensor):
    """The host-side export through the static tap tables equals JAX's
    (the same numpy taps and weights, summed alike), from a numpy array or
    a tensor, and agrees with the device export `export_envmap` within
    its test tolerance (its directions are f32, the taps' f64)."""
    base = np.random.RandomState(17).uniform(0, 2, (6, 16, 16, 3)).astype(
        np.float32)
    want = jax_light.export_envmap_np(base, (32, 64))
    got = light.export_envmap_np(torch.as_tensor(base) if as_tensor else base,
                                 (32, 64))
    assert got.dtype == np.float32 and got.shape == (32, 64, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, light.export_envmap(torch.as_tensor(base), (32, 64)).numpy(),
        rtol=1e-4, atol=5e-6)


def test_split_envmap_loss_matches_jax():
    """The fork's upper/lower-half envmap MSEs against a GT lat-long equal
    JAX's within 1e-6 relative (f32 means over the same samples)."""
    rng = np.random.RandomState(18)
    base = rng.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 2, (32, 64, 3)).astype(np.float32)
    want = jax_light.split_envmap_loss(jnp.asarray(base), jnp.asarray(gt))
    got = light.split_envmap_loss(torch.as_tensor(base), gt)
    assert got == pytest.approx(want, rel=1e-6)
    assert got[0] != got[1]


def _rgbe(img: np.ndarray) -> np.ndarray:
    """f32 RGB [H, W, 3] -> RGBE bytes [H, W, 4] (shared exponent)."""
    m = img.max(-1)
    mant, ex = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, ex + 128, 0)
    return out


def _rle(values: np.ndarray) -> bytes:
    """New-style RLE of one component of one scanline: runs of 3+ equal
    bytes as (128 + n, value), the rest as literal chunks (n, bytes...)."""
    out, i, w = bytearray(), 0, len(values)
    while i < w:
        j = i
        while j < w and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, values[i]])
            i = j
            continue
        j = i
        while j < w and j - i < 128 and not (
                j + 2 < w and values[j] == values[j + 1] == values[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(values[i:j])
        i = j
    return bytes(out)


def write_hdr(path: str, img: np.ndarray, rle: bool) -> np.ndarray:
    """Write a Radiance .hdr (flat or new-style RLE scanlines); returns
    the values a decoder must give, mantissa * 2^(e - 136)."""
    rgbe = _rgbe(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=1.0\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            if rle:
                f.write(bytes([2, 2, w >> 8, w & 255]))
                for c in range(4):
                    f.write(_rle(rgbe[y, :, c]))
            else:
                f.write(rgbe[y].tobytes())
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_read_radiance_hdr_matches_jax(tmp_path, rle):
    rng = np.random.RandomState(1)
    img = (rng.rand(12, 40, 3).astype(np.float32) * 4.0) ** 2
    img[2:4, 3:9] = 0.0          # exponent 0
    img[5, :] = 3.7              # constant row: runs
    path = str(tmp_path / "env.hdr")
    want = write_hdr(path, img, rle)
    got = light._read_radiance_hdr(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_light._read_radiance_hdr(path))
    if rle:
        assert os.path.getsize(path) < 12 * 40 * 4   # the runs compressed
    with pytest.raises(FileNotFoundError):
        light.load_hdr(str(tmp_path / "missing.hdr"))
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        light._read_radiance_hdr(str(bad))


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_weights():
    w = lpips_mod.random_lpips_weights(seed=3)
    ref = jax_lpips.random_lpips_weights(seed=3)
    assert set(w) == set(ref)
    for k in w:
        np.testing.assert_array_equal(w[k], ref[k])
    return w


def test_lpips_matches_jax(lpips_weights):
    """rtol 1e-4: f32 convolutions summed in another order."""
    rng = np.random.RandomState(11)
    a = rng.rand(3, 40, 48).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.15, size=a.shape), 0, 1).astype(
        np.float32)
    got = lpips_mod.lpips(torch.as_tensor(a), torch.as_tensor(b),
                          lpips_weights)
    want = jax_lpips.lpips(a, b, lpips_weights)
    assert got == pytest.approx(want, rel=1e-4)
    assert got > 0
    assert lpips_mod.lpips(torch.as_tensor(a), torch.as_tensor(a),
                           lpips_weights) == pytest.approx(0.0, abs=1e-9)


_FEAT_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def _write_weights(path, w, fmt):
    t = lambda a: torch.from_numpy(np.array(a))
    if fmt == "npz":
        np.savez(path, **w)
    elif fmt == "lpips_state_dict":
        slices = {0: (0, 2), 1: (2, 4), 2: (4, 7), 3: (7, 10), 4: (10, 13)}
        sd = {}
        for s, (lo, hi) in slices.items():
            for i in range(lo, hi):
                sd[f"net.slice{s + 1}.{_FEAT_IDX[i]}.weight"] = t(
                    w[f"conv{i}_w"])
                sd[f"net.slice{s + 1}.{_FEAT_IDX[i]}.bias"] = t(
                    w[f"conv{i}_b"])
        for j in range(5):
            sd[f"lin{j}.model.1.weight"] = t(w[f"lin{j}_w"].reshape(
                1, -1, 1, 1))
        torch.save(sd, path)
    else:
        vgg = {}
        for i, f in enumerate(_FEAT_IDX):
            vgg[f"features.{f}.weight"] = t(w[f"conv{i}_w"])
            vgg[f"features.{f}.bias"] = t(w[f"conv{i}_b"])
        vgg["classifier.0.weight"] = torch.zeros(2, 2)
        lin = {f"lins.{j}.model.1.weight": t(w[f"lin{j}_w"].reshape(
            1, -1, 1, 1)) for j in range(5)}
        torch.save({"vgg": vgg, "lin": lin}, path)


@pytest.mark.parametrize("fmt,ext", [("npz", "npz"),
                                     ("lpips_state_dict", "pth"),
                                     ("vgg_lin", "pth")])
def test_lpips_weight_formats(tmp_path, lpips_weights, fmt, ext):
    path = str(tmp_path / f"w.{ext}")
    _write_weights(path, lpips_weights, fmt)
    loaded = lpips_mod.maybe_load(path)
    ref = jax_lpips.load_lpips_weights(path)
    assert set(loaded) == set(lpips_weights) == set(ref)
    for k in loaded:
        np.testing.assert_array_equal(loaded[k], lpips_weights[k])
        np.testing.assert_array_equal(loaded[k], ref[k])
    assert lpips_mod.maybe_load("") is None
    assert lpips_mod.maybe_load(str(tmp_path / "missing.npz")) is None


# ---------------------------------------------------------------------------
# The eval CLIs
# ---------------------------------------------------------------------------

def _albedo_gt(data, size, seed=5):
    """r_{i}_albedo.png beside each test frame (random RGB)."""
    rng = np.random.RandomState(seed)
    with open(os.path.join(data, "transforms_test.json")) as f:
        frames = json.load(f)["frames"]
    for fr in frames:
        name = os.path.basename(fr["file_path"])
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
            os.path.join(data, "test", f"{name}_albedo.png"))


def test_render_cli_brdf_eval_matches_jax(tmp_path, lpips_weights):
    """The port's CLI with --brdf_eval on a `state_from_numpy` state
    against JAX's `eval_albedo` on the same fields: the median ratio
    within 1e-4, albedo PSNR within 0.01 dB. With --lpips_weights the
    CLI reports a finite lpips_avg."""
    data, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_blender_dataset(data, n_frames=2, size=32)
    _albedo_gt(data, 32)
    fields = gaussian_fields(n=1500, cap=2048, seed=2)
    cubemap = np.full((6, 16, 16, 3), 0.7, np.float32)

    jcfg = jax_cfg()
    jcfg.model.source_path = data
    jstate = types.SimpleNamespace(
        params=JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()},
                         active_sh_degree=3, max_sh_degree=3),
        cubemap=jnp.asarray(cubemap))
    recs = jax_load_scene(data, eval_split=True).test_cameras
    want = jax_render_cli.eval_albedo(jcfg, jstate, recs,
                                      str(tmp_path / "jax_albedo"))

    cfg = config.Config()
    cfg.raster = type(cfg.raster)(cap_instances=CAP)
    cfg.train.light_base_res = 16
    config.save_cfg(cfg, model)
    state_from_numpy(fields, cubemap, {"iteration": 7}, model)
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **lpips_weights)
    res = render_cli.main(["--model_path", model, "--source_path", data,
                           "--device", "cpu", "--brdf_eval",
                           "--lpips_weights", npz, "--backend", "jnp"])
    with open(os.path.join(model, "test", "ours_7", "pbr", "NVS.json")) as f:
        nvs = json.load(f)
    albedo_dir = os.path.join(model, "test", "ours_7", "albedo")
    with open(os.path.join(albedo_dir, "albedo_ratio.json")) as f:
        ratio = json.load(f)["albedo_ratio"]
    np.testing.assert_allclose(ratio, want["albedo_ratio"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(nvs["albedo_ratio"], ratio, rtol=0, atol=0)
    assert abs(nvs["albedo_psnr"] - want["albedo_psnr"]) < 0.01
    assert abs(nvs["albedo_ssim"] - want["albedo_ssim"]) < 1e-3
    assert np.isfinite(nvs["lpips_avg"]) and nvs["lpips_avg"] > 0
    assert nvs["lpips_avg"] == res["lpips_avg"]
    assert len(res["albedo_seconds"]) == 2 and len(res["lpips_seconds"]) == 2
    for i in range(2):
        assert os.path.exists(os.path.join(albedo_dir, f"albedo_{i:05d}.png"))


def test_relight_cli_matches_jax(tmp_path):
    """The port's relight CLI against JAX's on a JAX `save_state`
    checkpoint of the same fields, the same .hdr and the same saved albedo
    ratio, at --resolution 2: relit PNGs equal to within 1/255 on >= 99%
    of pixels (the GI march's one-ulp hit flips move a few pixels more)."""
    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_frames=2, size=64)
    fields = gaussian_fields(n=1500, cap=2048, seed=4)
    hdr = str(tmp_path / "sunset.hdr")
    rng = np.random.RandomState(6)
    write_hdr(hdr, rng.gamma(1.0, 1.5, (16, 32, 3)).astype(np.float32),
              rle=True)
    ratio = {"albedo_ratio": [0.9, 1.1, 1.05]}
    flags = ["--source_path", data, "--hdri", hdr, "--cubemap_res", "16",
             "--resolution", "2", "--backend", "jnp"]
    models = {}
    for side in ("jax", "port"):
        model = str(tmp_path / f"model_{side}")
        albedo = os.path.join(model, "test", "ours_7", "albedo")
        os.makedirs(albedo)
        with open(os.path.join(albedo, "albedo_ratio.json"), "w") as f:
            json.dump(ratio, f)
        models[side] = model
    jcfg = jax_cfg()
    jax_config.save_cfg(jcfg, models["jax"])
    params = JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()},
                       active_sh_degree=3, max_sh_degree=3)
    jax_ckpt.save_state(
        os.path.join(models["jax"], "chkpnt7.pkl"),
        JaxTrainState(params=params, opt_state=None, stats=None,
                      cubemap=jnp.zeros((6, 16, 16, 3)),
                      light_opt_state=None, key=None), {"iteration": 7})
    jax_relight.main(["--model_path", models["jax"], *flags])

    cfg = config.Config()
    cfg.raster = type(cfg.raster)(cap_instances=CAP)
    config.save_cfg(cfg, models["port"])
    state_from_numpy(fields, np.zeros((6, 16, 16, 3), np.float32),
                     {"iteration": 7}, models["port"])
    res = relight_cli.main(["--model_path", models["port"], *flags,
                            "--device", "cpu"])
    assert res["names"] == ["r_0", "r_1"] and len(res["view_seconds"]) == 2
    for name in ("r_0", "r_1", "envmap"):
        a, b = (np.asarray(Image.open(os.path.join(
            m, "test", "ours_7", "relight", "sunset", f"{name}.png")),
            np.int32) for m in (models["port"], models["jax"]))
        assert a.shape == b.shape
        assert a.shape[:2] == ((32, 32) if name != "envmap" else (512, 1024))
        assert (np.abs(a - b) <= 1).mean() >= 0.99, name
    assert np.asarray(Image.open(os.path.join(
        res["out_dir"], "r_0.png"))).max() > 0


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


@pytest.mark.parametrize("lpips_on", [False, True])
def test_relight_eval_cli_matches_jax(tmp_path, monkeypatch, lpips_weights,
                                      lpips_on):
    """Same files, both CLIs. SSIM within 1e-6; PSNR within 2e-5 dB: each
    side sums the f32 MSE in its own order, and a relative MSE error e
    moves PSNR by 4.34 e dB (one f32 ulp of a 10 dB value is 1e-6);
    LPIPS rtol 1e-4, as test_lpips_matches_jax. GT frames of 48 px are
    resized to --size 32 with PIL bilinear; every 10th frame id, one pair
    missing."""
    rng = np.random.RandomState(8)
    out_dir, gt_dir = str(tmp_path / "pred"), str(tmp_path / "gt")
    for fid in (10, 20, 30):
        _png(os.path.join(gt_dir, "lego", "sunset", f"r_{fid:04}.png"),
             rng.rand(48, 48, 4) * 255)
        if fid != 30:
            _png(os.path.join(out_dir, f"r_{fid:04}_sunset.png"),
                 rng.rand(32, 32, 3) * 255)
    monkeypatch.setenv("MAP_NAME", "sunset")
    monkeypatch.setenv("DATASET", "lego")
    monkeypatch.setenv("DATA_SUBDIR", "train_light")
    flags = ["--output_dir", out_dir, "--gt_dir", gt_dir, "--size", "32",
             "--num_test", "3"]
    if lpips_on:
        npz = str(tmp_path / "w.npz")
        np.savez(npz, **lpips_weights)
        flags += ["--lpips_weights", npz]
    out = os.path.join("relight", "lego", "relight_FROM_train_light",
                       "relight_TO_sunset", "sunset.json")
    results = []
    for side, fn in (("jax", jax_relight_eval.main),
                     ("port", lambda a: relight_eval_cli.main(
                         a + ["--device", "cpu"]))):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        fn(list(flags))
        with open(cwd / out) as f:
            results.append(json.load(f))
    got, want = results[1], results[0]
    assert set(got) == set(want)
    assert abs(got["psnr_avg"] - want["psnr_avg"]) <= 2e-5
    assert abs(got["ssim_avg"] - want["ssim_avg"]) <= 1e-6
    if lpips_on:
        assert got["lpips_avg"] == pytest.approx(want["lpips_avg"], rel=1e-4)
    else:
        assert got["lpips_avg"] is None and want["lpips_avg"] is None


def test_normal_eval_cli_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    out_dir, gt_dir = str(tmp_path / "out"), str(tmp_path / "gt")
    for tid in (0, 3):
        gt = rng.rand(24, 24, 4) * 255
        gt[..., 3] = np.where(rng.rand(24, 24) < 0.3, 0, 255)
        _png(os.path.join(gt_dir, f"test_{tid:03d}", "normal.png"), gt)
        for suffix in ("normal", "from_depth"):
            pred = rng.rand(24, 24, 3) * 255
            pred[:4] = (128, 128, 255)      # the encoded flat background
            _png(os.path.join(out_dir, "normal", f"{tid:05d}_{suffix}.png"),
                 pred)
    args = ["--output_dir", out_dir, "--gt_dir", gt_dir]
    jax_normal_eval.main(args)
    with open(os.path.join(out_dir, "normal_mae.json")) as f:
        want = json.load(f)
    got = normal_eval_cli.main(args)
    with open(os.path.join(out_dir, "normal_mae.json")) as f:
        written = json.load(f)
    assert written == got
    assert set(got) == set(want) == {"mae_gs", "mae_from_depth"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6


def test_collect_cli_matches_jax(tmp_path):
    rng = np.random.RandomState(10)
    for i in range(4):
        d = tmp_path / "runs" / f"scene{i}" / "pbr"
        d.mkdir(parents=True)
        (d / "NVS.json").write_text(json.dumps(
            {"psnr_avg": float(rng.rand() * 30), "ssim_avg": float(rng.rand()),
             "lpips_avg": None, "albedo_ratio": [1.0, 2.0, 3.0]}))
    (tmp_path / "runs" / "broken.json").write_text("{not json")
    (tmp_path / "runs" / "list.json").write_text("[1, 2]")
    outs = []
    for name, fn in (("jax", jax_collect.main), ("port", collect_cli.main)):
        out = str(tmp_path / f"{name}.json")
        fn(["--base", str(tmp_path / "runs"), "--out", out])
        with open(out) as f:
            outs.append(json.load(f))
    want, got = outs
    assert set(got) == set(want) == {"psnr_avg", "ssim_avg"}
    for k in want:
        assert got[k]["n"] == want[k]["n"] == 4
        for stat in ("mean", "std"):
            assert abs(got[k][stat] - want[k][stat]) <= 1e-6


def test_blender_loader_resolution_2_matches_jax(tmp_path):
    """--resolution 2 halves the frames through PIL's resize with its
    default filter, as JAX's loader: the images equal JAX's exactly."""
    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_frames=2, size=64)
    want = jax_load_scene(data, eval_split=True, resolution=2)
    got = load_scene(data, eval_split=True, resolution=2)
    for a, b in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert a.image.shape == (3, 32, 32)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.alpha, b.alpha)
        assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
    native = load_scene(data, eval_split=True, resolution=1)
    assert native.test_cameras[0].image.shape == (3, 64, 64)
