"""Optimizer steps that probe the `adam` kernel against the plain chain:
the Gaussians' ten groups at SH degree 3 (or the light's one group) at a
slot count whose group sizes are not multiples of 4, gradients holding
zeros, ~1e-12 residues, denormals and large values, second moments at 0
(so that eps 1e-15 sets the step), and the counts at which the scheduled
rates (xyz's, the BRDF's past its offset) and the bias corrections
differ. Shared by the CPU tests of the host table and the card tests of
the kernel, so it imports neither JAX nor the JAX package."""
import numpy as np
import torch

from gi_gs_tpu_torch.config import OptimizationConfig
from gi_gs_tpu_torch.train import optim

# the trained fields of one slot at SH degree 3: 67 floats
GAUSSIAN_SHAPES = {"xyz": (3,), "features_dc": (1, 3),
                   "features_rest": (15, 3), "opacity": (1,),
                   "normal": (3,), "albedo": (3,), "roughness": (1,),
                   "metallic": (1,), "scaling": (3,), "rotation": (4,)}
COUNTS = (1, 2, 3, 10, 30_001)
SLOTS = 1003                 # 1003, 3009, 4012, 45135 floats: ragged tails
LIGHT_RES = 6                # a 6 x 6 x 6 x 3 cubemap: 648 floats


def optimizer(group: str) -> optim.GroupAdam:
    """The train CLI's optimizer of `group` ("gaussians" or "light"):
    xyz's schedule, the BRDF's from its offset, the constant rates."""
    opt = OptimizationConfig()
    return (optim.build_optimizer(opt, 2.7) if group == "gaussians"
            else optim.build_light_optimizer(opt))


def _special(rng, shape) -> np.ndarray:
    """Random f32 gradients with zeros, ~1e-12 residues, denormals and
    large values mixed in."""
    g = rng.normal(0, 1e-3, shape)
    pick = rng.randint(0, 8, shape)
    g[pick == 0] = 0.0
    g[pick == 1] = rng.normal(0, 1e-12, shape)[pick == 1]
    g[pick == 2] = rng.choice([1e-40, -3e-42, 1e-45], shape)[pick == 2]
    g[pick == 3] = rng.normal(0, 1e17, shape)[pick == 3]
    return g.astype(np.float32)


def step_inputs(group: str, count: int, seed: int = 0, slots: int = SLOTS):
    """(view, grads, state) of a step from count - 1 steps done: random
    parameters, `_special` gradients and moments, nu at 0 where mu is
    (a slot the surgery re-allocated, or one never hit)."""
    rng = np.random.RandomState(seed)
    shapes = ({f: (slots,) + s for f, s in GAUSSIAN_SHAPES.items()}
              if group == "gaussians"
              else {"cubemap": (6, LIGHT_RES, LIGHT_RES, 3)})
    view, grads, state = {}, {}, {}
    for f, shape in shapes.items():
        view[f] = torch.tensor(rng.normal(0, 1, shape).astype(np.float32))
        grads[f] = torch.tensor(_special(rng, shape))
        mu = _special(rng, shape)
        nu = np.abs(_special(rng, shape)) ** 2 * (count > 1)
        mu[(rng.uniform(size=shape) < 0.2) | (count == 1)] = 0.0
        nu[mu == 0.0] = 0.0
        state[optim.GROUP_OF_FIELD.get(f, f)] = {
            "mu": torch.tensor(mu), "nu": torch.tensor(nu.astype(np.float32)),
            "count": count - 1}
    return view, grads, state


def to(view, grads, state, dev):
    """The same step's tensors on `dev`."""
    move = lambda d: {k: v.to(dev) for k, v in d.items()}
    return move(view), move(grads), {
        k: {"mu": s["mu"].to(dev), "nu": s["nu"].to(dev),
            "count": s["count"]} for k, s in state.items()}
