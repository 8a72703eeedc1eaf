"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit), and the least time they allow for a piece of
work: the larger of its bytes over the memory rate and its operations
over the compute rate. A frozen copy of nmcfluid_torch/utils/h100.py."""
HBM_BYTES_PER_S = 3.35e12      # device memory
F32_FLOPS = 67e12              # float32 outside the tensor cores
TF32_FLOPS = 495e12            # TF32 on the tensor cores


def bound_ms(n_bytes, flops, flops_per_s=F32_FLOPS):
    """(bound_ms, bound_by): the least time of `n_bytes` moved and `flops`
    computed at `flops_per_s`, and which of the two sets it ("bytes" or
    "operations")."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"
