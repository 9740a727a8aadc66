"""`conv_ms`: device milliseconds of the convolution and matrix-product
library kernels (cuDNN, cuBLAS, CUTLASS, cuFFT, and cuDNN's FFT
convolutions' pointwise products) per step of the traced units (a
refinement step, or a training iteration), by kernel name."""

LIBRARY = ("cudnn", "cublas", "cutlass", "gemm", "xmma", "conv", "dgrad", "wgrad", "fft",
           "pointwise_mult_and_sum")


def is_library(name: str) -> bool:
    lower = name.lower()
    return "at::native" not in name and any(part in lower for part in LIBRARY)


def read(run):
    t = run.trace
    if t is None:
        return None
    return 1e3 * t.time_s(is_library) / (t.units * run.steps_per_unit)
