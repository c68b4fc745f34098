"""K1's share of its roofline in the fit with HuMoR's term (ops/fk.py,
csrc/fk.cu): the least time of its launches over the device time of
fk_fwd_kernel and fk_bwd_kernel. Each step's term launches K1 once each way
on its 3B-row window (fit/model.py humor_dynamics_loss); every other launch
runs the main step's B rows (counts/k1.py at each shape, against
peaks.json)."""
from portbench.harness.readers import launched, load_module, peaks, \
    roofline_pct


def read(rec):
    k1, pk = load_module("counts", "k1"), peaks()
    shapes, steps = rec["shapes"], rec["steps"]
    wide = {**shapes, "B": 3 * shapes["B"]}

    def least(c):
        return max(c["flops"] / pk["tf32_flops"],
                   c["bytes"] / pk["hbm_bytes_per_s"])
    bound = 0.0
    for key, backward in (("fk_fwd", False), ("fk_bwd", True)):
        n = launched(rec, (key,))
        term = min(n, steps)
        bound += (term * least(k1.launch(wide, backward=backward))
                  + (n - term) * least(k1.launch(shapes, backward=backward)))
    return roofline_pct(rec, bound, "fk_fwd_kernel|fk_bwd_kernel",
                        ("fk_fwd", "fk_bwd"))
