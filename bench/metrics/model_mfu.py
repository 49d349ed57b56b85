"""The whole step's share of the chip's bf16 peak: the operations every
dispatch of the window needs, from its shapes (``costs.step_flops``:
2·params a token computed, the head, attention over the live context; no
padding), over the window's seconds × 989 TFLOP/s, in %."""

from harness import costs


def read(run):
    s = run.shape
    f = sum(costs.step_flops(c, params=s["params"], d_model=s["d_model"],
                             vocab=s["vocab"],
                             n_attn_layers=s["n_attn_layers"],
                             n_heads=s["n_heads"], head_dim=s["head_dim"],
                             block=s["block"]) for c in run.calls())
    return 100.0 * f / (run.seconds * costs.PEAK_BF16_FLOPS) if f else None
