"""The port's on-card attribution tools.

Each module does its work under `main()` (importing one runs nothing)
and runs on CUDA unless given `--device cpu`; without CUDA and without
`--device cpu` it raises. Its functions are also called by
`chip_smoke.py`. Run one as

    python -m generativeaiexamples_tpu_torch.scripts.<name> [--device cpu]

- `ttft_breakdown`: the TTFT stage table from the flight recorder.
- `decompose_decode`: a decode block timed with attention and
  quantize-on-write stubbed out.
- `decompose_bert_forward`: the BERT forward with attention removed and
  with one fused QKV projection.
- `decompose_encoders`: the embedding engine's host, device and readback
  split.
- `profile_card`: dispatch overhead, weight-read bandwidth, engine step
  times.

Every timing ends with a host read of the result (`.cpu()`), so a time
never rests on launch order alone.
"""

# H100 SXM peaks (NVIDIA data sheet), for the roofline bound here and in
# chip_smoke.py: the least time for some bytes and operations is the
# larger of bytes over the memory rate and operations over the peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Each port kernel's CUDA function name, as a profiler trace shows it.
KERNEL_FUNCTIONS = {"flash_attention": "flash_fwd_kernel",
                    "paged_attention": "paged_decode_kernel",
                    "encoder_attention": "encoder_attention_kernel",
                    "paged_attention_int8": "paged_int8_kernel",
                    "paged_attention_tree": "paged_tree_kernel",
                    "int8_matmul": "int8_matmul_kernel"}


def bound_ms(n_bytes: float, flops: float):
    """(least ms, "bytes" or "operations") for moving n_bytes and doing
    `flops` bf16 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_rows(prof) -> list:
    """(ms, count, name) of each device activity name in a finished
    torch.profiler profile, summed from the raw kineto events, largest
    first. The same rows as the device-time rows of `key_averages()`
    (whose FunctionEvent tree costs ~60 us an event)."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        ms, n = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (ms + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
    return sorted(((ms, n, k) for k, (ms, n) in agg.items() if ms > 0),
                  reverse=True)


def profile_device(run, device) -> list:
    """device_rows of one `run()` under torch.profiler, its results read
    back before the profile closes; [] off the card (no device
    activities to record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        run()
        return []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return device_rows(prof)
