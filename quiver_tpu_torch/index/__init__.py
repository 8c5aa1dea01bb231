"""Index engines and their registry (PyTorch port of
``quiver_tpu/index/__init__.py``).

Engine protocol (duck-typed):

  search_slots(queries f32[B,d], k, *, mask=None, negative=None,
               negative_weight=0.5, exact=False) -> (dist f32[B,k], slots i64[B,k])
  size -> int
  name -> str
  on_insert(slots, vectors) / on_update(slots, vectors) / on_delete(slots)
      (optional write hooks for engines that maintain derived state)

The port has every kind of the reference: ``exact``, ``ivf``, ``hnsw``,
``hybrid`` (with its IVF or HNSW backend) and the sharded ones,
``sharded_exact``, ``sharded_ivf``, ``sharded_hnsw`` and
``sharded_hybrid`` (``parallel/``). A sharded kind takes ``mesh``
(``parallel/sharded.resolve_mesh``): None (every visible card for a CUDA
store, the reference's ``make_mesh()``; the store's device otherwise), an
int n (n shards round-robin over those devices) or a sequence of device
names; shard s lives on ``mesh[s]``. Unknown kinds and unknown config
fields raise ``ValueError``.
"""

from __future__ import annotations

from quiver_tpu_torch.index.exact import ExactIndex

_ENGINES = {"exact": ExactIndex}


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
    the engine constructor. A sharded kind resolves as its base kind (the
    ``sharded_`` prefix stripped, ``quiver_tpu/index/__init__.py:51``) and
    takes a top-level ``"mesh"`` (None, an int or a list of device names),
    passed through as the ``mesh`` argument. Unknown fields raise
    ValueError (a REST layer maps it to 400)."""
    jcfg = dict(jcfg or {})
    mesh = {"mesh": jcfg.pop("mesh")} if kind.startswith("sharded_") and "mesh" in jcfg else {}
    _check_mesh(mesh.get("mesh"))
    ns = {k: jcfg.pop(k) for k in _CONFIG_NAMESPACES if isinstance(jcfg.get(k), dict)}
    base = kind.removeprefix("sharded_")
    out: dict = {}
    try:
        if base == "hybrid":
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
            return {**out, **mesh}
        stray = [k for k in ns if k != base]
        if stray:
            raise ValueError(f"engine_config namespaces {stray} do not apply to engine {kind!r}")
        out.update(ns.get(base, {}))
        out.update(jcfg)
        if base == "ivf":
            from quiver_tpu_torch.index.ivf import IVFConfig

            out = {"config": IVFConfig(**out)} if out else {}
        elif base == "hnsw":
            from quiver_tpu_torch.index.hnsw import HNSWConfig

            out = {"config": HNSWConfig(**out)} if out else {}
    except TypeError as e:  # unknown dataclass field
        raise ValueError(f"invalid engine_config for {kind!r}: {e}") from e
    return {**out, **mesh}


def _check_mesh(mesh) -> None:
    """A JSON ``mesh`` is None, a positive int or a non-empty list of
    device names; anything else raises ValueError."""
    import torch

    if mesh is None:
        return
    if isinstance(mesh, bool) or not isinstance(mesh, (int, list)):
        raise ValueError(f"mesh must be null, an int or a list of device names, got {mesh!r}")
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh of {mesh} shards")
        return
    if not mesh:
        raise ValueError("empty mesh")
    for dev in mesh:
        try:
            torch.device(dev)
        except (RuntimeError, TypeError) as e:
            raise ValueError(f"mesh device {dev!r}: {e}") from e


def _sharded_hybrid(store, **cfg):
    """The hybrid over sharded engines (``quiver_tpu/index/__init__.py:
    123-167``): the exact side a ``ShardedExactIndex``, the ANN side a
    ``ShardedIVFIndex`` (its IVFConfig knobs: ``ivf_config`` or flat
    overrides) or, when graph knobs are given (``hnsw_config`` or flat
    HNSW fields) or ``ann_backend="hnsw"``, a ``ShardedHNSWIndex``. The ANN
    engine's exact fallback reads the exact side's row mirrors, so the
    corpus is on the mesh's devices once."""
    from quiver_tpu_torch.index.hybrid import HybridIndex
    from quiver_tpu_torch.parallel.sharded import ShardedExactIndex, resolve_mesh

    mesh = resolve_mesh(cfg.pop("mesh", None), store.device)
    compute_dtype = cfg.get("compute_dtype")
    dtype_kw = {"compute_dtype": compute_dtype} if compute_dtype is not None else {}
    backend = cfg.pop("ann_backend", "auto")
    ivf_config = cfg.pop("ivf_config", None)
    hnsw_config = cfg.pop("hnsw_config", None)
    adaptive_config = cfg.pop("adaptive_config", None)
    exact = ShardedExactIndex(store, mesh, **dtype_kw)
    if backend == "auto":
        hnsw_keys = {
            "m", "m0", "ef_construction", "ef_search", "max_level",
            "level_prob", "build_batch", "visited", "build_approx", "query_dtype",
        }
        backend = "hnsw" if (hnsw_config is not None or hnsw_keys & set(cfg)) else "ivf"
    if backend == "ivf":
        from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        ivf_kw = dict(cfg)
        if ivf_config is not None:
            ivf_kw["config"] = ivf_config

        def ann_factory(s):
            return ShardedIVFIndex(s, mesh, mirrors_of=exact, **ivf_kw)
    elif backend == "hnsw":
        from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

        hnsw_kw = dict(cfg)
        if hnsw_config is not None:
            hnsw_kw["config"] = hnsw_config

        def ann_factory(s):
            return ShardedHNSWIndex(s, mesh, mirrors_of=exact, **hnsw_kw)
    else:
        raise ValueError(f"unknown ann_backend {backend!r}")
    return HybridIndex(
        store,
        adaptive_config=adaptive_config,
        exact_factory=lambda s: exact,
        ann_factory=ann_factory,
    )


def make_engine(kind: str, store, **cfg):
    """Build an engine over a VectorStore. Kinds: exact | ivf | hnsw |
    hybrid | sharded_exact | sharded_ivf | sharded_hnsw | sharded_hybrid
    (and any registered one)."""
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
    elif kind == "sharded_exact":
        from quiver_tpu_torch.parallel.sharded import ShardedExactIndex

        factory = ShardedExactIndex
    elif kind == "sharded_ivf":
        from quiver_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        factory = ShardedIVFIndex
    elif kind == "sharded_hnsw":
        from quiver_tpu_torch.parallel.sharded_graph import ShardedHNSWIndex

        factory = ShardedHNSWIndex
    elif kind == "sharded_hybrid":
        factory = _sharded_hybrid
    else:
        raise ValueError(f"unknown index engine: {kind!r}")
    try:
        return factory(store, **cfg)
    except TypeError as e:  # an unknown constructor or config field
        raise ValueError(f"invalid config for engine {kind!r}: {e}") from e
