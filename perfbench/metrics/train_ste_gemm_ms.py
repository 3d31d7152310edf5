"""Device ms per training step of the float32 GEMMs (cuBLAS SGEMM, TF32
off): the straight-through estimator's products, forward ``x @ w`` and the
backward's ``g @ w.T`` and ``x.T @ g``, from the profiler by kernel name."""

MARKS = ("sgemm", "f32f32_f32", "gemm_f32", "nvjet_sss", "s1688gemm", "s16816gemm")


def is_sgemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MARKS) and "bf16" not in low


def read(trace):
    steps = trace.counters.get("steps")
    if not steps:
        return None
    t = trace.device_seconds(is_sgemm)
    return t / steps * 1e3 if t > 0 else None
