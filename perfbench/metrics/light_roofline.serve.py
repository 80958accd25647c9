"""The light's prefilter at serving time, % of its roofline: the least
work of one build times the builds per view (the program's counter
light_builds, window A), over `light_device_ms.serve`'s time (the span
light, window B), against the H100's peaks. Nothing where either reads
nothing.

The least work of one build of a light whose base cubemap is R x R a face:
the specular levels R, R/2, .. down to 16, each prefiltered from the level
of its own size, and the diffuse from level 16.

- Operations: 2 per tap and colour channel, over every output texel's
  taps. A level wider than 32 takes a (2h+1)^2 patch of taps; 32 and 16
  take every texel of their level (6 x 32^2, 6 x 16^2), and so does the
  diffuse at 16. The halo h is the one that holds the GGX lobe keeping
  0.99 of the NDF at the level's roughness (renderutils' __ndfBounds),
  as the prefilter defines it: 7, 20 and 28 at 256, 128 and 64.
- Bytes: the base cubemap read once, every specular level and the
  diffuse written once, in f32 RGB.

At R = 256 that is ~2.26 GFLOP and ~11.0 MB a build: ~0.034 ms at the
f32 peak. The count and its constants are the yardstick's own, so it
reads the same whatever implements the prefilter, a kernel that computes
its weights instead of reading the tables included."""
import functools
import math

import numpy as np

from perfbench import cells, work
from perfbench.spans import counter

MIN_RES = 16                 # the coarsest specular level
DENSE_MAX_RES = 32           # levels up to this width filter densely
MIN_ROUGHNESS, MAX_ROUGHNESS = 0.08, 0.5
CUTOFF = 0.99                # the share of the NDF the lobe keeps
TEXEL_BYTES = 12             # f32 RGB


def levels(base_res: int):
    """(width, roughness) of each specular level."""
    res = [base_res]
    while res[-1] > MIN_RES:
        res.append(res[-1] // 2)
    n = len(res)
    if n < 3:
        return [(r, 1.0) for r in res]
    return [(r, i / (n - 2) * (MAX_ROUGHNESS - MIN_ROUGHNESS)
             + MIN_ROUGHNESS) for i, r in enumerate(res[:-1])] + \
        [(res[-1], 1.0)]


@functools.lru_cache(maxsize=16)
def halo(res: int, roughness: float) -> int:
    """The patch's halo at a level: the lobe's angle in texels of 2/res,
    with a margin of 1.6x and 2 texels, at most half the face."""
    a2 = roughness ** 4
    cos_t = np.cos(np.linspace(0.0, np.pi / 2.0, 1_000_000))
    d = (cos_t * a2 - cos_t) * cos_t + 1.0
    cdf = np.cumsum(a2 / (d * d * np.pi))
    cos_cut = float(cos_t[int(np.argmax(cdf >= cdf[-1] * CUTOFF))])
    theta = math.acos(min(cos_cut, 1.0))
    return min(int(math.ceil(theta / (2.0 / res) * 1.6)) + 2, res // 2)


def count(base_res: int):
    """(operations, bytes) of one build at base resolution `base_res`."""
    flops, texels = 0, 6 * base_res ** 2
    for r, rough in levels(base_res):
        out = 6 * r * r
        taps = out if r <= DENSE_MAX_RES else (2 * halo(r, rough) + 1) ** 2
        flops += 2 * 3 * out * taps
        texels += out
    diffuse = 6 * MIN_RES ** 2
    flops += 2 * 3 * diffuse * diffuse
    texels += diffuse
    return flops, TEXEL_BYTES * texels


def read(t):
    x = getattr(t, "inputs", None)
    ms = cells.metric_reader("light_device_ms.serve")(t)
    builds = counter(t, "light_builds")
    if x is None or not ms or not builds:
        return None
    flops, nbytes = count(x.cfg.train.light_base_res)
    return work.share(builds * nbytes, builds * flops, ms * 1e-3)
