"""Bytes one Adam step over n float32 parameters must move: read p, g,
mu and nu, write p, mu and nu (7 x 4 B a parameter), as PERF.md's kernel
table counts them."""


def step_bytes(n: int) -> int:
    return 28 * n
