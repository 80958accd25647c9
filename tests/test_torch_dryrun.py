"""The port's multi-rank dry run (gi_gs_tpu_torch/dryrun.py) on gloo ranks
on the CPU (tests/torch_dist_workers.py): its five legs on 2 ranks, and its
multihost leg (per-rank images, `grow_state` mid-run) on 4. The dry run
checks on every rank that all ranks hold bit-identical states after each
leg; these tests check the same again on the states the ranks return, and
that the densification fired, the cubemap moved and the capacity
doubled. The phase-2 leg reads a small env-BRDF LUT."""
import numpy as np
import pytest
import torch

from gi_gs_tpu_torch import dryrun
from gi_gs_tpu_torch.ops import shading

import torch_dist_workers as workers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lut():
    return shading._brdf_lut_np(256, 64)


def _bit_equal(ranks, leg):
    first = ranks[0][leg]["state"]
    for r in ranks[1:]:
        other = r[leg]["state"]
        assert first.keys() == other.keys()
        for k in first:
            assert np.array_equal(first[k], other[k]), (leg, k)


def test_dryrun_five_legs_two_ranks(tmp_path, lut):
    ranks = workers.run_ranks("dryrun", {"lut": lut}, tmp_path, world=2)
    r = ranks[0]
    a0, a1 = r["phase1_dp"]["alive"]
    assert a0 == 100 and a1 > a0          # densified at step 2
    assert r["phase2_dp"]["cubemap_change"] > 0
    assert np.isfinite(r["tile_sharded"]["loss"])
    # every rank composites its tiles and gathers them: the same loss,
    # and partial gradients that together are nonzero
    assert ranks[1]["tile_sharded"]["loss"] == r["tile_sharded"]["loss"]
    assert np.abs(r["tile_sharded"]["grad"]).sum() + \
        np.abs(ranks[1]["tile_sharded"]["grad"]).sum() > 0
    assert np.isfinite(r["ts_train"]["loss"])
    assert r["multihost"]["capacity"] == (128, 256)
    for leg in ("phase1_dp", "phase2_dp", "ts_train", "multihost"):
        _bit_equal(ranks, leg)
    # the densify statistics were reset on the densified slots alike
    st = r["phase1_dp"]["state"]
    assert st["alive"].sum() == a1


def test_dryrun_multihost_leg_four_ranks(tmp_path, lut):
    ranks = workers.run_ranks("dryrun", {"lut": lut, "multihost_only": True},
                              tmp_path, world=4)
    m = ranks[0]["multihost"]
    assert m["alive"][1] != m["alive"][0]
    assert m["capacity"] == (128, 256)
    # grow_state kept every slot and padded the rest dead; step 3 does
    # not densify
    st = m["state"]
    assert st["xyz"].shape[0] == 256
    assert not st["alive"][128:].any()
    assert st["alive"].sum() == m["alive"][1]
    assert all(np.isfinite(v) for v in m["loss"])
    assert len({tuple(r["multihost"]["loss"]) for r in ranks}) == 1
    _bit_equal(ranks, "multihost")


def test_dryrun_needs_a_process_group_of_its_size():
    with pytest.raises(ValueError, match="process group"):
        dryrun.dryrun_multichip(2, device="cpu")
