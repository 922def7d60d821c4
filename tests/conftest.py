"""Test configuration: run everything on a virtual 8-device CPU mesh.

The platform is selected with `jax.config.update` (it works as long as no
backend has been created yet) and XLA_FLAGS is read at backend creation.
`FRT_TEST_PLATFORM=cuda` runs the suite on a GPU instead; the tests marked
`gpu` need it.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("FRT_TEST_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", False)
