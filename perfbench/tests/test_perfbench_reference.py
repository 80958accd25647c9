"""The plain reference computed in blocks of tiles agrees with itself
computed whole, at a tiny size: the forward bit for bit; the gradients
to rounding. A CPU reduction over few rows splits its work across
threads by the size of its input, so some of a block's sums round in
another order: here 24 to 30 entries of 12,288 move, by 7e-6 of the
leaf's norm at most."""
from __future__ import annotations

import dataclasses

import torch

from perfbench import loops, scenes
from perfbench.sides import REFERENCE, Side

from tiny import tiny_cell


def _render_and_grads(tile_block: int):
    cell = tiny_cell("lego800.train_p1")
    side = Side(REFERENCE)
    dev = torch.device("cpu")
    cfg = loops._config(side, cell)
    cfg.raster = dataclasses.replace(cfg.raster, tile_block=tile_block)
    fields = scenes.scene_fields(cell.config, 5, dev)
    params = side.params(cell.config, fields, dev)
    view = scenes.rig(cell.config, 5).train[0]
    view = dataclasses.replace(view, width=256, height=64)   # 4 x 4 tiles
    cam = side.camera_list([view], dev)[0]
    leaves = {k: getattr(params, k).clone().requires_grad_(True)
              for k in ("xyz", "features_dc", "opacity", "scaling")}
    import importlib
    renderer = importlib.import_module(f"{REFERENCE}.renderer")
    res = renderer.render(cam, params.replace(**leaves), torch.zeros(3),
                          cfg.raster, cfg.gi, compute_occlusion=False)
    loss = (res["render"] * torch.linspace(0, 1, 64 * 256).reshape(
        1, 64, 256)).sum() + res["depth_map"].sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return res["render"].detach(), grads


def test_blocks_of_tiles_agree_with_the_whole_image():
    whole, g_whole = _render_and_grads(0)
    blocked, g_blocked = _render_and_grads(3)      # 16 tiles in 6 blocks
    assert whole.abs().sum() > 0
    assert torch.equal(whole, blocked)
    for a, b in zip(g_whole, g_blocked):
        assert a.abs().sum() > 0
        assert float(torch.linalg.norm(a - b)) <= 1e-4 * float(
            torch.linalg.norm(a))
