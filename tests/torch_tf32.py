"""TF32 rounding and float32-accurate TF32 products, emulated by bit
operations in plain torch: what `mma.sync` TF32 and the 3xTF32 split of
`src/repro_torch/csrc/tf32x3.cuh` compute, for the port's CPU tests of
the kernels that use them (ssd_scan, flash_attn)."""
import torch


def tf32(t, *, truncate=False):
    """float32 -> TF32 (10 mantissa bits) by bit operations: the nearest
    value (ties away from zero, as `cvt.rna.tf32.f32`), or `truncate`d."""
    u = t.contiguous().view(torch.int32)
    return ((u if truncate else u + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(passes):
    """a @ b from TF32 operands on float32 sums, as the kernels' mma:
    one pass of the nearest TF32 values, or three, of the kernels' split
    a = big + small (big truncated, small = a - big to nearest)."""
    def mm(a, b):
        if passes == 1:
            return tf32(a) @ tf32(b)
        ab, bb = tf32(a, truncate=True), tf32(b, truncate=True)
        return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb
    return mm
