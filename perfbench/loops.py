"""Set-up, the measured window and the checked steps of a cell, for both
sides: the one generator that every traffic mix (`traffic/<mix>.json`)
parameterises. A mix's `kind` names which of the system's two entry
points it drives, and its other keys shape the traffic:

- `train`: training steps issued back to back, as the train CLI issues
  them, from iteration `start_iteration` in phase `phase` (1 or 2);
  the port's own schedule (densify, prune, opacity reset) follows from
  the iteration. `instance_headroom` (default 1) multiplies the
  instance and tile-depth capacities sized at set-up, for traffic whose
  population grows in the window.
- `serve`: `render_pbr_view` over the test cameras in seeded order.
  Without `arrival_fps` one client renders in a closed loop, as the
  render CLI and a viewer do; with it, views arrive at that fixed rate
  (an open loop) and each view's latency runs from its arrival; a
  traced run's windows render back to back whatever the rate.
  `relight_every` k > 0 builds the light anew from a new seeded cubemap
  before every k-th view of the window, inside that view's time.

The set-up functions take a `Side` (sides.py): the program's run and the
reference's check build their objects from the same generated inputs by
the same calls, each with its own package."""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scenes
from .sides import (REFERENCE, Side, change_norms, fast_forward_counts,
                    first_gradients, leaves)

# tiles per plain compositing call in the reference (bounds its memory)
REF_TILE_BLOCK = 256


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def view_order(n_views: int, length: int, seed: int) -> List[int]:
    """`length` view indices: seeded permutations of the n views, one
    after the other (each view once per pass, as the train CLI draws)."""
    rng = scenes.host_rng(seed, 4)
    out: List[int] = []
    while len(out) < length:
        out.extend(int(i) for i in rng.permutation(n_views))
    return out[:length]


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 and held in float32 (the control's inputs)."""
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def _config(side: Side, cell):
    port = {g: dict(v) for g, v in cell.config["port"].items()}
    for g, v in cell.traffic.get("port", {}).items():
        port.setdefault(g, {}).update(v)
    cfg = side.make_config(dict(cell.config, port=port))
    if side.package == REFERENCE:
        cfg.raster = dataclasses.replace(cfg.raster, tile_block=REF_TILE_BLOCK)
    return cfg


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainRun:
    cfg: object
    state: object
    step: object
    cams: list
    image: torch.Tensor
    alpha: torch.Tensor
    bg: torch.Tensor
    n_alive: int
    light: bool                 # the light trains (phase 2)
    it0: int                    # the iteration of the first step


def _mark(marks: Optional[Dict[str, float]], name: str, dev) -> None:
    """Seconds since the previous mark, under `name` (set-up's parts)."""
    if marks is not None:
        sync(dev)
        now = time.perf_counter()
        marks[name] = now - marks.pop("_t", now)
        marks["_t"] = now


def train_setup(side: Side, cell, seed: int, dev, control: bool = False,
                marks: Optional[Dict[str, float]] = None) -> TrainRun:
    """The training step and its state at iteration `start_iteration` of
    the mix, from the seed. With `control`, every input (the Gaussian
    fields, the targets and the cubemap) is rounded to bfloat16 first.
    `marks`, if given, receives the seconds of each part of the set-up."""
    _mark(marks, "start", dev)
    c, tr = cell.config, cell.traffic
    rnd = bf16 if control else (lambda t: t)
    rig = scenes.rig(c, seed)
    cfg = _config(side, cell)
    fields = {k: rnd(v) for k, v in scenes.scene_fields(c, seed, dev).items()}
    params = side.params(c, fields, dev)
    cams = side.camera_list(rig.train, dev)
    v0 = rig.train[0]
    image, alpha = scenes.targets(len(cams), v0.height, v0.width,
                                  c["cameras"]["masked"], seed, dev)
    image = rnd(image)
    _mark(marks, "inputs", dev)
    tx = side.optim.build_optimizer(cfg.opt, rig.extent)
    ltx = side.optim.build_light_optimizer(cfg.opt)
    state = side.trainer.make_train_state(cfg, params, rig.extent,
                                          seed=seed % (1 << 63), tx=tx)
    cube = rnd(scenes.cubemap(cfg.train.light_base_res, seed, dev))
    state = state.replace(cubemap=cube,
                          light_opt_state=ltx.init({"cubemap": cube}))
    it0 = tr["start_iteration"]
    state = fast_forward_counts(state, it0 - 1)
    _mark(marks, "state", dev)
    side.size_capacities(cfg, params, cams, tr.get("instance_headroom", 1.0))
    _mark(marks, "capacities", dev)
    light = tr["phase"] == 2
    step = (side.trainer.make_phase2_step(cfg, rig.extent, tx, ltx, dev)
            if light else side.trainer.make_phase1_step(cfg, rig.extent, tx))
    _mark(marks, "step_tables", dev)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                    device=dev)
    return TrainRun(cfg, state, step, cams, image, alpha, bg,
                    c["n_gaussians"], light, it0)


def train_steps(run: TrainRun, order: List[int], first: int, count: int):
    """Issue steps first .. first + count - 1 of the view order back to
    back (no synchronisation); returns their StepAux."""
    out = []
    for i in range(first, first + count):
        v = order[i]
        run.state, aux = run.step(run.state, run.cams[v], run.image[v],
                                  run.alpha[v], run.bg, run.it0 + i)
        out.append(aux)
    return out


def checked_steps(run: TrainRun, order: List[int], count: int) -> Dict:
    """The first `count` steps, with what the check compares: each
    step's loss, the first step's gradient per leaf as the optimizer got
    it, and each leaf's change over the `count` steps."""
    before = leaves(run.state, run.n_alive, run.light)
    losses, grads, aux = [], None, []
    for i in range(count):
        a = train_steps(run, order, i, 1)[0]
        losses.append(float(a.loss))
        aux.append(a)
        if i == 0:
            grads = first_gradients(run.state, run.n_alive, run.light)
    return dict(losses=losses, grads=grads,
                changes=change_norms(before, leaves(run.state, run.n_alive,
                                                    run.light)),
                overflow=max(int(a.overflow) for a in aux))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeRun:
    cfg: object
    state: object                 # .params, .cubemap
    light: object
    cams: list
    bg: torch.Tensor
    render: object                # render_pbr_view
    relight: object               # index -> (cubemap, light)
    relight_every: int            # 0: the light built once
    fps: float                    # arrivals per second; 0: closed loop
    light_index: int = 0


def serve_setup(side: Side, cell, seed: int, dev, control: bool = False,
                marks: Optional[Dict[str, float]] = None) -> ServeRun:
    """A scene, its cubemap and light (built at set-up), and the test
    cameras. With `control`, the fields and the cubemaps are rounded to
    bfloat16."""
    _mark(marks, "start", dev)
    c = cell.config
    rnd = bf16 if control else (lambda t: t)
    rig = scenes.rig(c, seed)
    cfg = _config(side, cell)
    fields = {k: rnd(v) for k, v in scenes.scene_fields(c, seed, dev).items()}
    params = side.params(c, fields, dev)
    cams = side.camera_list(rig.test, dev)
    cube = rnd(scenes.cubemap(cfg.train.light_base_res, seed, dev))
    _mark(marks, "inputs", dev)
    side.size_capacities(cfg, params, cams)
    _mark(marks, "capacities", dev)
    light = side.render_cli.build_light(cfg, cube)
    _mark(marks, "light_tables", dev)

    def relight(j: int):
        cj = rnd(scenes.cubemap(cfg.train.light_base_res, seed, dev, index=j))
        return cj, side.render_cli.build_light(cfg, cj)

    return ServeRun(cfg, types.SimpleNamespace(params=params, cubemap=cube),
                    light, cams, torch.zeros(3, device=dev),
                    side.render_cli.render_pbr_view, relight,
                    int(cell.traffic.get("relight_every", 0)),
                    float(cell.traffic.get("arrival_fps", 0.0)))


def serve_view(run: ServeRun, v: int):
    """One view, ended by its render_rgb copied to host memory: the
    host copy and the view's overflow flag."""
    out = run.render(run.cfg, run.state, run.cams[v], run.bg, light=run.light)
    return out["render_rgb"].cpu().numpy(), out["overflow"]


def serve_at(run: ServeRun, order: List[int], i: int):
    """The view at window position i, the light rebuilt first where the
    mix relights at that position."""
    j = i // run.relight_every if run.relight_every else 0
    if j != run.light_index:
        run.state.cubemap, run.light = run.relight(j)
        run.light_index = j
    return serve_view(run, order[i])


def serve_window(run: ServeRun, order: List[int], seconds: float,
                 keep) -> Dict:
    """Views from window position 0 for `seconds`: closed loop, or at the
    mix's arrival rate. Returns each view's latency and completion time
    (seconds from the window's start), the window's length, the
    overflow flags and the host copies of the positions in `keep`."""
    fps = run.fps
    lat: List[float] = []
    done: List[float] = []
    ovfs: List[torch.Tensor] = []
    kept: Dict[int, np.ndarray] = {}
    t0 = time.perf_counter()
    i = 0
    while True:
        # closed loop: a view starts when the last ends; open loop: at its
        # arrival. Every view that arrives within the window is served.
        arrival = t0 + i / fps if fps else time.perf_counter()
        if arrival - t0 >= seconds:
            break
        wait = arrival - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rgb, ovf = serve_at(run, order, i)
        now = time.perf_counter()
        lat.append(now - arrival)
        done.append(now - t0)
        ovfs.append(ovf)
        if i in keep:
            kept[i] = rgb
        i += 1
    return dict(latency=lat, done=done, window=time.perf_counter() - t0,
                overflow=ovfs, kept=kept)


def sample_positions(seed: int, count: int, within: int) -> List[int]:
    """`count` window positions below `within`, drawn from the seed: the
    views whose outputs the check compares."""
    rng = scenes.host_rng(seed, 5)
    return sorted(int(i) for i in rng.choice(within, count, replace=False))
