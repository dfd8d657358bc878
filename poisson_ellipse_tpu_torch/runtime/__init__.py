"""runtime — the serving layer's warm buckets and kernel-library cache.

The counterpart of ``poisson_ellipse_tpu.runtime``'s compilation cache
(:mod:`.compile_cache`): shape bucketing, the warm pool of captured
chunk graphs for the batched engines, and the kernel libraries' directory
(``enable_persistent_cache``). The JAX package's native host runtime, its
solve cache and its autotune registry are not ported here (ROADMAP.md
Queue A).
"""

from poisson_ellipse_tpu_torch.runtime.compile_cache import (
    WarmPool,
    bucket_dim,
    enable_persistent_cache,
    grid_bucket,
    lane_bucket,
    warm_affinity_key,
    warm_pool,
)

__all__ = [
    "WarmPool",
    "bucket_dim",
    "enable_persistent_cache",
    "grid_bucket",
    "lane_bucket",
    "warm_affinity_key",
    "warm_pool",
]
