"""Block geometry of the fused program's in-kernel cover.

≙ the knobs of ``geomesa_tpu.index.prune`` the fused program reads: the
table is cut into gather blocks of ``BLOCK_SIZE`` rows in index order; a
query's block gate keeps the blocks whose summaries can hold a match, and
the pruned branch gathers them while at most ``PRUNE_MAX_FRACTION`` of the
blocks are alive. Both resolve through the config registry on every access
(PEP 562), so ``GEOMESA_TPU_PRUNE_BLOCK``/``GEOMESA_TPU_PRUNE_MAX_FRAC`` and
``config.*.set`` overrides apply at run time.
"""

from __future__ import annotations

from geomesa_tpu_torch import config

_CONFIG_ATTRS = {
    "BLOCK_SIZE": config.PRUNE_BLOCK,
    "PRUNE_MAX_FRACTION": config.PRUNE_MAX_FRACTION,
}


def __getattr__(name: str):
    prop = _CONFIG_ATTRS.get(name)
    if prop is None:
        raise AttributeError(name)
    return prop.get()
