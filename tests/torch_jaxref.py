"""Shared by tests/test_torch_*.py: how the JAX reference is compiled."""

import contextlib

import jax

_FLAG = "jax_disable_most_optimizations"


@contextlib.contextmanager
def light_xla():
    """Compile the JAX programs first called inside the block with most XLA
    optimizations off. The references the port is held to are integer
    programs, so their results do not depend on the optimization level,
    and at these test sizes the compile, not the run, is the cost: it
    takes about a quarter less CPU time this way. The flag is process
    wide, so it is put back on leaving the block."""
    old = jax.config.read(_FLAG)
    jax.config.update(_FLAG, True)
    try:
        yield
    finally:
        jax.config.update(_FLAG, old)
