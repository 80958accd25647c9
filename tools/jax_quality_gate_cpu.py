"""The JAX quality gate's phase-1 protocol (tools/quality_gate.py,
P1_PROTOCOL) run on the CPU with the rasterizer's jnp oracles
(use_pallas=False, expand_backend="xla"): JAX's own figure with f32 knn
scales at the init, to set beside the port's QUALITY_H100.json (the TPU
figures of QUALITY_r05.json start from knn scales of a bf16 distance
matmul).

    JAX_PLATFORMS=cpu python tools/jax_quality_gate_cpu.py OUT.json [--bf16-knn]

--bf16-knn rounds both operands of the knn's distance matmul to bf16, as
a TPU's default matmul precision does (gi_gs_tpu/ops/knn.py:98-100 asks
for none); everything else stays f32. The init cloud and the GT scene
both take their scales from that knn, as on the TPU.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tools.quality_gate as jq  # noqa: E402


def mean_knn_dist2_bf16(points, chunk=512):
    """gi_gs_tpu/ops/knn.py's exact path with the distance matmul's
    operands rounded to bf16 (f32 products and sums)."""
    import jax
    import jax.numpy as jnp

    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)), constant_values=1e8)
    sq = (points * points).sum(-1)

    def body(carry, start):
        q = jax.lax.dynamic_slice(pts, (start, 0), (chunk, 3))
        qsq = (q * q).sum(-1)
        d2 = qsq[:, None] + sq[None, :] - 2.0 * jnp.matmul(
            bf16(q), bf16(points).T, precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(d2, 0.0)
        total = jnp.zeros((chunk,), points.dtype)
        for k in range(4):  # first pass removes the self-distance
            m = d2.min(axis=1)
            if k > 0:
                total = total + m
            kill = d2 <= m[:, None]
            first = kill & (jnp.cumsum(kill, axis=1) == 1)
            d2 = jnp.where(first, jnp.inf, d2)
        return carry, total / 3.0

    starts = jnp.arange(0, n + pad, chunk)
    _, out = jax.lax.scan(body, 0, starts)
    return out.reshape(-1)[:n]


def main(out_path: str, bf16_knn: bool) -> None:
    build = jq._build_cfg

    def oracle_cfg(*a, **k):
        c = build(*a, **k)
        c.raster = dataclasses.replace(c.raster, use_pallas=False,
                                       expand_backend="xla")
        return c

    jq._build_cfg = oracle_cfg
    if bf16_knn:
        import gi_gs_tpu.models.gaussians as gaussians
        gaussians.mean_knn_dist2 = mean_knn_dist2_bf16
    t0 = time.time()
    res = jq.run_phase1_gate(**jq.P1_PROTOCOL)
    res["seconds"] = time.time() - t0
    res["device"] = "cpu (JAX, jnp oracles)"
    res["knn"] = "bf16 operands" if bf16_knn else "f32"
    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1], "--bf16-knn" in sys.argv[2:])
