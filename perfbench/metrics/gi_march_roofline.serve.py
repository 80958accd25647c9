"""The exact march's % of its roofline in the first traced view: the
bound of its SSAO and its SSR launch over their device time.

Bytes per march: the G-buffer planes read once (SSAO: view normal and
position, 6 planes; SSR: those and the lit colour, 9) and the outputs
written once (SSAO 1 plane, SSR 4), and the direction table.
Operations: perfbench/work.py's per-sample count of the samples each
walk takes."""
from perfbench import work

PLANES = ((6, 1), (9, 4))       # (in, out) of the SSAO and the SSR march


def count(t):
    ms = work.march_walks(t)
    if not ms or not any(m["samples"] for m in ms):
        return None
    nbytes = sum(4 * m["pixels"] * (i + o) + 16 * m["directions"]
                 for m, (i, o) in zip(ms, PLANES))
    return nbytes, sum(work.march_flops(m) for m in ms)


def read(t):
    return work.roofline(t, "gi_march", len(PLANES), count)
