"""The counts of portbench/counts against FLOPs and bytes worked out by
hand at small shapes."""

from portbench.harness.readers import load_module


def test_k1_counts():
    k1 = load_module("counts", "k1")
    # B=2 rows, J=3 joints: 2 joints below the root, 75 and 147 FLOPs each
    assert k1.launch({"B": 2, "J": 3}) == {"flops": 75 * 2 * 2,
                                           "bytes": 4 * 2 * 3 * 24}
    assert k1.launch({"B": 2, "J": 3}, backward=True) == {
        "flops": 147 * 2 * 2, "bytes": 4 * 2 * 3 * 45}


def test_k2_counts():
    k2 = load_module("counts", "k2")
    # per (row, vertex): two sides of 1245 + 576 + 18, |diff| 9, the
    # gradient 18 + 1242 + 9 + 576 + 3
    assert k2.PER_ROW_VERTEX == 2 * 1839 + 9 + 1848 == 5535
    c = k2.launch({"B": 2, "V": 5})
    reads = 2 * 2 * 495 + 15 + 207 * 15 + 24 * 5
    writes = 1 + 2 * 495 + 15
    assert c == {"flops": 5535 * 10, "bytes": 4 * (reads + writes)}


def test_fit_step_counts():
    fit = load_module("counts", "fit_step")
    s = {"B": 1, "V": 1, "J": 2, "H": 1, "K": 1, "C": 1,
         "vposer_neurons": 1, "vposer_latent": 1, "gmm_components": 1}
    want = 5535                                   # K2, one row and vertex
    want += 3 * 75 + 2 * 147                      # K1, one joint below root
    want += 4 * 207 * 2160 + 4 * 30 * 24 * 12     # the fused joint tables
    want += 6 * (2 + 2 + 144 + 3)                 # MotionNet, H = 1
    want += 4 * (63 + 2 + 2) + 2 * (1 + 1 + 126)  # VPoser
    want += 6 * 69 * 69                           # the GMM
    assert fit.step(s)["flops"] == want

