"""Index engines and their registry (PyTorch port of
``quiver_tpu/index/__init__.py``).

Engine protocol (duck-typed):

  search_slots(queries f32[B,d], k, *, mask=None, negative=None,
               negative_weight=0.5, exact=False) -> (dist f32[B,k], slots i64[B,k])
  size -> int
  name -> str
  on_insert(slots, vectors) / on_update(slots, vectors) / on_delete(slots)
      (optional write hooks for engines that maintain derived state)

The port has the ``exact``, ``ivf``, ``hnsw`` and ``hybrid`` engines (the
hybrid with its IVF or HNSW backend). The sharded kinds of the reference
raise ``NotImplementedError`` naming their ROADMAP.md item; unknown kinds
and unknown config fields raise ``ValueError``.
"""

from __future__ import annotations

from quiver_tpu_torch.index.exact import ExactIndex

_ENGINES = {"exact": ExactIndex}

#: the reference's kinds that the port has not yet, with their ROADMAP.md item
_NOT_PORTED = {
    "sharded_exact": "queue 1, item 5",
    "sharded_hnsw": "queue 1, item 5",
    "sharded_ivf": "queue 1, item 5",
    "sharded_hybrid": "queue 1, item 5",
}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"engine {kind!r} is not ported to quiver_tpu_torch yet "
        f"(ROADMAP.md {_NOT_PORTED[kind]})"
    )


def register_engine(name: str, factory) -> None:
    _ENGINES[name] = factory


#: namespaces a JSON engine_config may use; each maps to the matching typed
#: config dataclass
_CONFIG_NAMESPACES = ("ivf", "hnsw", "adaptive")


def resolve_engine_config(kind: str, jcfg: dict | None) -> dict:
    """Translate a JSON-safe per-collection engine config into constructor
    kwargs for :func:`make_engine` (``quiver_tpu/index/__init__.py:30-92``).

    Accepted shape: ``{"ivf": {...IVFConfig fields...}, "hnsw":
    {...HNSWConfig fields...}, "adaptive": {...AdaptiveConfig fields...},
    <flat knob>: <scalar>, ...}``: a namespaced block configures the
    matching engine (the hybrid's keys must all be namespaced; its ``ivf``,
    ``hnsw`` and ``adaptive`` blocks become ``ivf_config``, ``hnsw_config``
    with ``ann_backend="hnsw"``, and ``adaptive_config``); flat keys pass to
    the engine constructor. Unknown fields raise ValueError (a REST layer
    maps it to 400). Kinds the port lacks raise NotImplementedError."""
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
    jcfg = dict(jcfg or {})
    ns = {k: jcfg.pop(k) for k in _CONFIG_NAMESPACES if isinstance(jcfg.get(k), dict)}
    out: dict = {}
    try:
        if kind == "hybrid":
            if jcfg:
                raise ValueError(
                    f"hybrid engine_config keys must be namespaced "
                    f"({'/'.join(_CONFIG_NAMESPACES)}); got {sorted(jcfg)}"
                )
            if "ivf" in ns:
                from quiver_tpu_torch.index.ivf import IVFConfig

                out["ivf_config"] = IVFConfig(**ns["ivf"])
            if "hnsw" in ns:
                from quiver_tpu_torch.index.hnsw import HNSWConfig

                out["hnsw_config"] = HNSWConfig(**ns["hnsw"])
                out["ann_backend"] = "hnsw"
            if "adaptive" in ns:
                from quiver_tpu_torch.index.hybrid import AdaptiveConfig

                out["adaptive_config"] = AdaptiveConfig(**ns["adaptive"])
            return out
        stray = [k for k in ns if k != kind]
        if stray:
            raise ValueError(f"engine_config namespaces {stray} do not apply to engine {kind!r}")
        out.update(ns.get(kind, {}))
        out.update(jcfg)
        if kind == "ivf":
            from quiver_tpu_torch.index.ivf import IVFConfig

            out = {"config": IVFConfig(**out)} if out else {}
        elif kind == "hnsw":
            from quiver_tpu_torch.index.hnsw import HNSWConfig

            out = {"config": HNSWConfig(**out)} if out else {}
    except TypeError as e:  # unknown dataclass field
        raise ValueError(f"invalid engine_config for {kind!r}: {e}") from e
    return out


def make_engine(kind: str, store, **cfg):
    """Build an engine over a VectorStore. Kinds: exact | ivf | hnsw |
    hybrid (and any registered one)."""
    if kind in _ENGINES:
        factory = _ENGINES[kind]
    elif kind == "ivf":
        from quiver_tpu_torch.index.ivf import IVFIndex

        factory = IVFIndex
    elif kind == "hnsw":
        from quiver_tpu_torch.index.hnsw import HNSWIndex

        factory = HNSWIndex
    elif kind == "hybrid":
        from quiver_tpu_torch.index.hybrid import HybridIndex

        factory = HybridIndex
    elif kind in _NOT_PORTED:
        raise _not_ported(kind)
    else:
        raise ValueError(f"unknown index engine: {kind!r}")
    try:
        return factory(store, **cfg)
    except TypeError as e:  # an unknown constructor or config field
        raise ValueError(f"invalid config for engine {kind!r}: {e}") from e
