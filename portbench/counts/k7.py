"""K7 (GroupNorm + ReLU, ops/groupnorm.py): the operations and bytes one
launch needs at the cell's shapes, R rows of C columns in G groups
(HuMoR's CVAE: R the batch's transitions, C its 1024-wide layers).

Forward, per value: the group's sum (1 add), the centred square (a
subtraction and a multiply-add), the normalised value (a subtraction and
a product), the affine step (a multiply-add) and the ReLU: 8 operations.
Backward (dx alone, HuMoR's weights frozen): the normalised value again
(2), the mask (a multiply-add and a select), gz gamma (1), the two group
sums (1 and 2), and dx (a subtraction, a multiply-add and a product): 12.
Bytes: each input read once and each output written once, float32: x in
and y out forward; x and the cotangent in and dx out backward; gamma and
beta, and the (R, G) means and reciprocal deviations, once either way."""

FWD_FLOP = 8
BWD_FLOP = 12


def launch(shapes: dict, backward: bool = False) -> dict:
    R, C, G = shapes["humor_rows"], shapes["humor_width"], \
        shapes["humor_groups"]
    small = 2 * C + 2 * R * G
    if backward:
        return {"flops": BWD_FLOP * R * C, "bytes": 4 * (3 * R * C + small)}
    return {"flops": FWD_FLOP * R * C, "bytes": 4 * (2 * R * C + small)}
