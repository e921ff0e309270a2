"""Device ms per step of cuBLAS / CUTLASS matrix-product kernels."""

from modcr_bench.metrics._lib import GEMM, kernel_ms_per_step


def read(run):
    return kernel_ms_per_step(run, *GEMM)
