"""K1's share of its roofline in the fit (ops/fk.py, csrc/fk.cu): the least
time of its forward and backward launches (counts/k1.py at the cell's
shapes, against peaks.json) over the device time of fk_fwd_kernel and
fk_bwd_kernel."""
from portbench.harness.readers import launched, load_module, peaks, \
    roofline_pct


def read(rec):
    k1, pk = load_module("counts", "k1"), peaks()

    def least(c):
        return max(c["flops"] / pk["tf32_flops"],
                   c["bytes"] / pk["hbm_bytes_per_s"])
    bound = (launched(rec, ("fk_fwd",)) * least(k1.launch(rec["shapes"]))
             + launched(rec, ("fk_bwd",))
             * least(k1.launch(rec["shapes"], backward=True)))
    return roofline_pct(rec, bound, "fk_fwd_kernel|fk_bwd_kernel",
                        ("fk_fwd", "fk_bwd"))
