"""K1 (forward kinematics, ops/fk.py): the operations and bytes one launch
needs at the cell's shapes. Per joint below the root the forward composes
R = R_p R_l (27 multiply-adds) and t = R_p t_l + t_p (9 and 3 adds); the
backward takes twice the products, the parent's and the local cotangents.
Bytes: each input read once and each output written once, float32."""

FWD_FLOP_PER_JOINT = 2 * (27 + 9) + 3
BWD_FLOP_PER_JOINT = 2 * 2 * (27 + 9) + 3


def launch(shapes: dict, backward: bool = False) -> dict:
    B, J = shapes["B"], shapes["J"]
    if backward:
        # reads R_l, t_l, R_g and the cotangents of R_g and t_g; writes
        # those of R_l and t_l
        return {"flops": BWD_FLOP_PER_JOINT * (J - 1) * B,
                "bytes": 4 * B * J * (9 + 3 + 9 + 9 + 3 + 9 + 3)}
    return {"flops": FWD_FLOP_PER_JOINT * (J - 1) * B,
            "bytes": 4 * B * J * (9 + 3 + 9 + 3)}
