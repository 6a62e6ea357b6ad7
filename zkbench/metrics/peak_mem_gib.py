"""The device memory the window held at its peak, in GiB: the CUDA
allocator's `max_memory_allocated()` over the window (reset once set-up
has ended, so the key it keeps is counted, set-up's transients not)."""


def read(run):
    return run.peak_bytes / 2**30
