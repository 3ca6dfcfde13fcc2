"""Shared WorkerSpec serialization + content fingerprinting.

Both worker runtimes describe a worker by the same ``WorkerSpec``
dataclass (core/workers); this module is the single place that turns a
spec into a *content fingerprint* — a small dict of stable hex digests
over the parts that must agree for two processes to produce
byte-identical records:

- ``router``: ``engine._router_fingerprint`` — a content hash over the
  router's thresholds, classifier weights, and encoder parameters (the
  same tag the result-store cache keys on).
- ``engine_config``: the serialized ``EngineConfig`` fields (α budget,
  batch size, backend names, routing mode, seed).
- ``backends``: the ``(module, attr)`` backend-registry factory pairs.

The spec's torch ``device`` is not part of the fingerprint: the records
of a batch are equal on the card and on the CPU, so workers on
different devices belong to one fleet.

``launch.worker_main`` recomputes the fingerprint after rebuilding its
router on its own device and verifies it against the coordinator-stamped
value (guarding serialization drift between coordinator and worker
builds), and the fabric admission check (core/fabric) compares a
dialing-in worker's fingerprint against the coordinator's before
admitting it to the fleet. ``describe_mismatch`` names the first
differing field so a rejected worker gets an actionable error, not a
bare hash inequality.

This module deliberately imports only ``core.engine`` and the encoder
(never ``core.workers``) so ``workers -> specs -> engine`` stays
acyclic; the ``spec`` arguments are duck-typed.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core.engine import _router_fingerprint
from repro_torch.models.encoder import (encoder_from_jax_params,
                                        encoder_to_jax_params)

# the fingerprint keys, in the order mismatches are reported
FINGERPRINT_FIELDS = ("router", "engine_config", "backends")


@dataclasses.dataclass
class PortableRouter:
    """A router in the form that crosses a process (or machine)
    boundary: the ``AdaParseRouter`` without its encoder module, the
    encoder's parameters as host numpy (``encoder_to_jax_params``: bf16
    comes out as float32, which holds it exactly), and the source
    router's fingerprint. No tensor travels, so no card memory is tied
    to the receiver; ``materialize_router`` rebuilds the encoder on the
    receiver's own device."""

    router: object                 # AdaParseRouter with encoder=None
    enc_params: dict               # numpy leaves, layers stacked
    fingerprint: str               # _router_fingerprint of the source


def portable_router(router):
    """A copy of the router safe to pickle across process (and machine)
    boundaries. A router without an encoder (the ft variant) is numpy
    already and ships as it is."""
    enc = getattr(router, "encoder", None)
    if enc is None:
        return router
    return PortableRouter(dataclasses.replace(router, encoder=None),
                          encoder_to_jax_params(enc),
                          _router_fingerprint(router))


def materialize_router(router, device):
    """The receiver's half of ``portable_router``: rebuild the encoder
    on ``device`` (a resolved torch device). The result carries no
    memoised fingerprint, so ``_router_fingerprint`` hashes the rebuilt
    parameters — which must equal the source's."""
    if not isinstance(router, PortableRouter):
        return router
    enc = encoder_from_jax_params(router.enc_params, router.router.enc_cfg,
                                  device)
    return dataclasses.replace(router.router, encoder=enc)


def router_fingerprint(router) -> str:
    """``_router_fingerprint`` of a router or of its portable form."""
    if isinstance(router, PortableRouter):
        return router.fingerprint
    return _router_fingerprint(router)


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(b"%d:" % len(p))
        h.update(p)
    return h.hexdigest()[:16]


def engine_config_fingerprint(ecfg) -> str:
    """Stable digest of the EngineConfig fields that shape records:
    field order is the dataclass declaration order, so two builds of
    the same config hash identically regardless of construction."""
    parts = []
    for f in dataclasses.fields(ecfg):
        parts.append(f.name.encode())
        parts.append(repr(getattr(ecfg, f.name)).encode())
    return _digest(*parts)


def backend_specs_fingerprint(backend_specs) -> str:
    """Digest of the ``(module, attr)`` backend factory pairs (order-
    sensitive: registration order is part of the registry contract)."""
    parts = []
    for mod, attr in tuple(backend_specs or ()):
        parts.append(str(mod).encode())
        parts.append(str(attr).encode())
    return _digest(*parts)


def spec_fingerprint(spec) -> dict:
    """Content fingerprint of a WorkerSpec-shaped object (duck-typed:
    needs ``.router``, ``.ecfg``, ``.backend_specs``). Two workers with
    equal fingerprints produce byte-identical records for the same
    batch keys — the fabric admission bar."""
    return {
        "router": router_fingerprint(spec.router),
        "engine_config": engine_config_fingerprint(spec.ecfg),
        "backends": backend_specs_fingerprint(spec.backend_specs),
    }


def describe_mismatch(expected: dict, got: dict) -> str | None:
    """None when the fingerprints agree; otherwise an actionable
    message naming the first differing field and both digests."""
    for field in FINGERPRINT_FIELDS:
        e, g = expected.get(field), got.get(field)
        if e != g:
            hint = {
                "router": "the worker was built from a different "
                          "router (retrain or ship the coordinator's "
                          "router file)",
                "engine_config": "EngineConfig differs (α / batch size "
                                 "/ backend names / seed must match "
                                 "the coordinator)",
                "backends": "backend registry spec differs (the "
                            "worker registers different (module, attr) "
                            "factories)",
            }[field]
            return (f"worker fingerprint mismatch on {field!r}: "
                    f"coordinator={e} worker={g} — {hint}")
    extra = set(got) - set(FINGERPRINT_FIELDS)
    if extra:
        return (f"worker fingerprint carries unknown fields "
                f"{sorted(extra)} (version skew between coordinator "
                f"and worker builds)")
    return None
