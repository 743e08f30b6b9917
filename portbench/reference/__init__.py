"""The benchmark's plain reference of the attested computation.

Plain PyTorch and NumPy, independent of the program under test (it
imports nothing of it): the quantized block forward (``forward``), the
BabyBear field, Poseidon2 and the Ligero-style commitment that turns a
vector of 16-bit words into a Merkle root (``commit``).  It is a frozen
copy of the semantics the program was held to, byte for byte, when the
benchmark was defined; the benchmark compares the program's outputs with
it, so a later change to the program cannot move the yardstick.
"""
