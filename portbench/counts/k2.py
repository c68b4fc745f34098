"""K2 (the fused v2v prior, ops/lbs.py skin_v2v_l1 in its fused mode):
the operations and bytes one launch needs at the cell's shapes, for B rows
and V vertices. Per (row, vertex), a side poses the vertex (207 x 3
multiply-adds and 3 adds), blends the 24 transforms (12 x 24) and applies
the 3 x 4 transform (9 multiply-adds); both sides are posed, |rec - orig|
summed (9), and the gradient of the original side taken: the sign's
cotangent through the rotation (9 multiply-adds), the pose features (3 x
207), the blended transform (9 + 12 x 24) and the shaped vertex (3).
Bytes: each input read once (both sides' pose features and transforms, the
shaped vertices, posedirs and the weights) and each output written once
(the total, and the gradients of the pose features, the transforms and the
shaped vertices), float32."""

POSE = 2 * 621 + 3
BLEND = 2 * 288
SIDE = POSE + BLEND + 2 * 9
L1 = 9
GRAD = 2 * 9 + 2 * 621 + 9 + 2 * 288 + 3
PER_ROW_VERTEX = 2 * SIDE + L1 + GRAD


def launch(shapes: dict) -> dict:
    B, V = shapes["B"], shapes["V"]
    reads = 2 * B * (207 + 288) + 3 * V + 207 * 3 * V + 24 * V
    writes = 1 + B * (207 + 288) + 3 * V
    return {"flops": PER_ROW_VERTEX * B * V, "bytes": 4 * (reads + writes)}
