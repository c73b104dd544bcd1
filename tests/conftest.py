"""Test config: run JAX on a virtual 8-device CPU backend.

This is the standard JAX fake-backend trick (SURVEY.md §4): sharding
tests get 8 host devices without a multi-card machine. Must run before
the first JAX backend touch. The persistent compile cache stays off, so
entry points that point it at the checkout (the CLI) reuse nothing
compiled elsewhere.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
