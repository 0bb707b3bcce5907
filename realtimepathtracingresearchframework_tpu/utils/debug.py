"""Numerical watchdogs — the counterpart of the reference's runtime
validation stack (SURVEY §5.2).

The reference leans on Vulkan validation layers + CHECK_VULKAN everywhere
(vulkan/vulkan_utils.h:16-22,140-142); a functional JAX program has no data
races by construction, so the corresponding safety net here is numerical:
NaN trapping inside jit (``jax_debug_nans``) and explicit finite checks on
readback boundaries.
"""

from __future__ import annotations

import numpy as np

from realtimepathtracingresearchframework_tpu.utils.error_io import throw_error


def enable_nan_debugging() -> None:
    """Trap NaN production inside jitted programs (re-runs the offending op
    un-jitted and raises with a traceback). Expensive — debug only."""
    import jax

    jax.config.update("jax_debug_nans", True)


def disable_nan_debugging() -> None:
    import jax

    jax.config.update("jax_debug_nans", False)


def assert_all_finite(tree, name: str = "value") -> None:
    """Host-side finite check over a pytree of arrays (use at readback
    boundaries; forces a device sync)."""
    import jax

    for i, leaf in enumerate(jax.tree.leaves(tree)):
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            throw_error(
                "%s: leaf %d has %d non-finite values (shape %s)",
                name,
                i,
                bad,
                a.shape,
            )
