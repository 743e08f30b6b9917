"""Hand-written CUDA kernels of the port, each with its plain PyTorch version."""
from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launch count in this process (``ntt_long_rows``: the
    part of K2's made on rows longer than 2^15 words)."""
    from . import modmatmul, ntt_kernel, poseidon2_kernel, sumcheck_fold
    from . import sumcheck_round
    return dict(poseidon2=poseidon2_kernel.launches, ntt=ntt_kernel.launches,
                sumcheck_round=sumcheck_round.launches,
                modmatmul=modmatmul.launches,
                sumcheck_fold=sumcheck_fold.launches,
                ntt_long_rows=ntt_kernel.long_launches)
