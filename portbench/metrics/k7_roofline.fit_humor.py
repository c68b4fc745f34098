"""K7's share of its roofline in the fit with HuMoR's term (ops/groupnorm.py,
csrc/groupnorm.cu): the least time of its forward and backward launches
(counts/k7.py at the cell's shapes; the bytes at peaks.json's HBM rate
bound them) over the device time of the kernels named humor_gn_*."""
from portbench.harness.readers import launched, load_module, peaks, \
    roofline_pct


def read(rec):
    k7, pk = load_module("counts", "k7"), peaks()

    def least(c):
        return max(c["flops"] / pk["f32_flops"],
                   c["bytes"] / pk["hbm_bytes_per_s"])
    bound = (launched(rec, ("humor_gn_fwd",)) * least(k7.launch(rec["shapes"]))
             + launched(rec, ("humor_gn_bwd",))
             * least(k7.launch(rec["shapes"], backward=True)))
    return roofline_pct(rec, bound, "humor_gn_",
                        ("humor_gn_fwd", "humor_gn_bwd"))
