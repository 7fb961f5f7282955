"""A stream on which a trial selector's pick refuses the whole input (test
side only): Huffman's 15-bit length cap converges on the first 64 KiB's
counts and not on the whole stream's."""
import numpy as np


def prefix_converges_whole_refuses(scale=32, seed=0):
    """A byte stream whose first 64 KiB (four symbols, dyadic counts) makes
    ``entropy_auto``'s trial pick Huffman, and whose whole counts (the
    Fibonacci counts of ``_fibonacci_bytes`` times ``scale`` after it) make
    Huffman's 15-bit cap fail (1,549,280 bytes at scale 32)."""
    rng = np.random.default_rng(seed)
    f = [1, 1]
    while len(f) < 22:
        f.append(f[-1] + f[-2])
    syms = (np.arange(22, dtype=np.uint8) * 3 + 100).astype(np.uint8)
    p = 2.0 ** -np.arange(1, 5)
    head = rng.choice(syms[::-1][:4], size=1 << 16, p=p / p.sum())
    tail = np.repeat(syms, np.array(f) * scale)
    rng.shuffle(tail)
    return np.concatenate([head, tail])
