"""G-buffers for the march tests, shared by the CPU tests against JAX and
the card tests (so it imports no JAX): a smooth depth field with a hard
edge, and the same with block centres of the coherent march set to the
cases where its offset table degenerates."""
import numpy as np


def smooth_scene(h, w, seed=0):
    """Unit normals facing the camera (with noise) and the view positions
    of depth 2.5 + waves, 0.8 deeper on the right half; fx = fy."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.5 + 0.4 * np.sin(xs / 11.0) + 0.3 * np.cos(ys / 7.0)
    z[:, w // 2:] += 0.8
    fx = float(np.float32(0.9 * w))
    pos = np.stack([(xs - w / 2.0) / fx * z, (ys - h / 2.0) / fx * z, z],
                   0).astype(np.float32)
    n = rng.randn(3, h, w).astype(np.float32)
    n[2] -= 1.5
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    return n, pos, fx, fx


def degenerate_centres(h, w, seed=0):
    """`smooth_scene` with the centre pixel (16 by + 8, 128 bx + 64) of
    the coherent march's blocks set to: a normal at +up (block 0, 0) and
    at -up (0, 1), where the TBN's tangent and bitangent vanish; a zero
    normal (1, 0); a centre at z = 1e-6 with its normal along x (1, 1),
    whose marched depth stays near 0 (or below it) for the directions
    near the image plane, so their projected offsets run past +-2047 and
    are clipped. Needs h >= 32 and w >= 256; a w whose
    last block centre lies past the image (w = 272: column 320) adds a
    centre in the zero padding."""
    assert h >= 32 and w >= 256
    n, pos, fx, fy = smooth_scene(h, w, seed)
    c = lambda by, bx: (slice(None), 16 * by + 8, 128 * bx + 64)
    n[c(0, 0)] = (0.0, 1.0, 0.0)
    n[c(0, 1)] = (0.0, -1.0, 0.0)
    n[c(1, 0)] = 0.0
    n[c(1, 1)] = (1.0, 0.0, 0.0)
    pos[c(1, 1)] = (3e-4, -2e-4, 1e-6)
    return n, pos, fx, fy
