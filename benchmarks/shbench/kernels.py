"""Bytes that a kernel's launches need at the least, from their shapes.

K5 (``csrc/hash_append.cu``, kernel ``k_hash_append``) appends one stack of
batches to the counting buffer: per row it reads the packed bases (two
bits a base), the N mask (one bit a base) and the length (4 bytes) once,
and writes one 8-byte key a window of the row, padding windows included
(every batch appends ``rows x (row_len - k + 1)`` slots).
"""

K5_NAME = "k_hash_append"


def k5_bytes(batches: int, rows: int, row_len: int, k: int) -> int:
    per_row = (row_len - k + 1) * 8 + row_len // 4 + row_len // 8 + 4
    return batches * rows * per_row
