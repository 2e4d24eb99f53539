"""Operations of the SER CNN (paper Sec. 3.1) per example, and the bytes
of one member step's per-example gradient matrix."""


def param_count(m: dict) -> int:
    k, c0, c1, c2 = m["kernel"], m["n_mels"], m["channels1"], m["channels2"]
    t4 = m["time_frames"] // 4
    return (k * c0 * c1 + c1 + 2 * c1 + k * c1 * c2 + c2 + 2 * c2
            + t4 * c2 * m["fc_dim"] + m["fc_dim"]
            + m["fc_dim"] * m["num_classes"] + m["num_classes"])


def forward_flops(m: dict) -> int:
    """Multiply-adds x 2 of one example's forward: the two convolutions
    (SAME padding, the second at half the frames) and the two dense
    layers; GroupNorm, ReLU and pooling are not counted."""
    k, c0, c1, c2 = m["kernel"], m["n_mels"], m["channels1"], m["channels2"]
    t = m["time_frames"]
    return 2 * (t * c0 * c1 * k + (t // 2) * c1 * c2 * k
                + (t // 4) * c2 * m["fc_dim"] + m["fc_dim"] * m["num_classes"])


def member_step(m: dict, batch: int):
    """-> (bytes, flops) of one member's local step: forward and backward
    (3x the forward) of ``batch`` examples, and the (B, D) f32 matrix of
    per-example gradients written once and read once."""
    return 2 * batch * param_count(m) * 4, 3 * batch * forward_flops(m)
