"""K2's share of its roofline in the fit (ops/lbs.py, csrc/v2v.cu): the
least time of its launches (counts/k2.py at the cell's shapes, against the
TF32 peak and HBM bandwidth of peaks.json) over the device time of the
kernels of its launches: v2v_fused_kernel, and the total_kernel and
range_reduce_kernel that finish each launch."""
from portbench.harness.readers import MissingKernel, launched, \
    load_module, peaks, roofline_pct

KEYS = ("v2v_grad",)


def read(rec):
    if launched(rec, KEYS) == 0:
        return None
    # the helper kernels alone, with K2's own renamed, are no reading
    if not any("v2v_fused_kernel" in k for k, _, _ in rec["kernels"]):
        raise MissingKernel("the program launched v2v_grad but no device "
                            "operation is named v2v_fused_kernel")
    c = load_module("counts", "k2").launch(rec["shapes"])
    pk = peaks()
    bound = launched(rec, KEYS) * max(c["flops"] / pk["tf32_flops"],
                                      c["bytes"] / pk["hbm_bytes_per_s"])
    return roofline_pct(rec, bound,
                        "v2v_fused_kernel|total_kernel|range_reduce_kernel",
                        KEYS)
