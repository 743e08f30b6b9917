"""Peak device memory allocated over set-up and window, GiB
(torch.cuda.max_memory_allocated)."""


def read(run):
    return run.peak_bytes / float(1 << 30)
