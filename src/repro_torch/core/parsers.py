"""The parser fleet: quality channels + cost models (§3.1, Figs. 3 & 5).

Cost model calibration (single Polaris node = 32 CPU cores + 4 A100):
- abstract: Nougat parses 1-2 PDF/s/node; §5.1: PyMuPDF throughput is
  135x Nougat and 13x pypdf; Fig. 5: PyMuPDF ≈ 315 PDF/s at 128 nodes
  with an FS-contention plateau; Marker ≈ 0.1 PDF/s average at scale;
  Nougat ≈ 8 PDF/s at 128 nodes.

Quality profiles reproduce the Fig. 3 crossing structure: extraction is
best on easy born-digital docs, collapses on scans/scrambled layers;
Nougat is flat-but-page-dropping; GROBID truncates (low coverage).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import (ChannelProfile, CorpusConfig, Document,
                                  corrupt_document)


@dataclasses.dataclass(frozen=True)
class ParserSpec:
    name: str
    channel: ChannelProfile
    pdf_per_sec_node: float          # single-node steady-state throughput
    uses_gpu: bool
    warmup_s: float = 0.0            # model-load time (15 s for ViT, §5.2)
    io_bytes_per_doc: float = 2e6    # read PDF + write text
    scale_cap_nodes: int = 10 ** 9   # e.g. Marker fails to scale past 10


# Channel severities calibrated against Table 1 (born-digital regime):
# target BLEU  pymupdf 51.9 > tesseract 48.8 > nougat 48.1 > marker 47.5
#              > pypdf 43.6 >> grobid 26.5; coverage 91-97 (marker top);
# plus the Fig. 3 crossing: extraction collapses at high difficulty
# (difficulty_power >= 2.5), recognition parsers stay flat.
PARSER_SPECS: dict[str, ParserSpec] = {
    "pymupdf": ParserSpec(
        "pymupdf",
        ChannelProfile(p_ws=0.10, p_sub=0.08, p_scramble=0.45, p_char=0.12,
                       p_latex=0.85, p_ident=0.3, p_page_drop=0.085,
                       difficulty_power=3.0, flat_floor=0.13,
                       text_layer=True),
        pdf_per_sec_node=202.0, uses_gpu=False, io_bytes_per_doc=2.5e6),
    "pypdf": ParserSpec(
        "pypdf",
        ChannelProfile(p_ws=0.28, p_sub=0.10, p_scramble=0.38, p_char=0.14,
                       p_latex=0.9, p_ident=0.4, p_page_drop=0.08,
                       difficulty_power=2.5, flat_floor=0.16,
                       text_layer=True),
        pdf_per_sec_node=15.5, uses_gpu=False),
    "nougat": ParserSpec(
        "nougat",
        ChannelProfile(p_sub=0.17, p_char=0.10, p_latex=0.10, p_ident=0.12,
                       p_page_drop=0.07, difficulty_power=1.0,
                       flat_floor=0.52, text_layer=False),
        pdf_per_sec_node=1.5, uses_gpu=True, warmup_s=15.0),
    "marker": ParserSpec(
        "marker",
        ChannelProfile(p_sub=0.18, p_char=0.11, p_latex=0.18, p_ident=0.15,
                       p_page_drop=0.033, difficulty_power=1.2,
                       flat_floor=0.50, text_layer=False),
        pdf_per_sec_node=0.65, uses_gpu=True, warmup_s=12.0,
        scale_cap_nodes=10),
    "tesseract": ParserSpec(
        "tesseract",
        ChannelProfile(p_ws=0.10, p_sub=0.12, p_scramble=0.05, p_char=0.13,
                       p_latex=0.75, p_ident=0.25, p_page_drop=0.085,
                       difficulty_power=1.4, flat_floor=0.28,
                       text_layer=False),
        pdf_per_sec_node=4.2, uses_gpu=False),
    "grobid": ParserSpec(
        "grobid",
        ChannelProfile(p_ws=0.05, p_sub=0.16, p_scramble=0.12, p_char=0.09,
                       p_latex=0.8, p_ident=0.3, p_page_drop=0.12,
                       p_fail=0.12, difficulty_power=1.5, flat_floor=0.68,
                       text_layer=True),
        pdf_per_sec_node=7.0, uses_gpu=False),
}

# AdaParse restricts itself to two parsers for scalability (App. C)
CHEAP_PARSER = "pymupdf"
EXPENSIVE_PARSER = "nougat"
# order of the m=6 accuracy-regression outputs (GROBID excluded per Table 4)
REGRESSION_PARSERS = ("pymupdf", "pypdf", "nougat", "marker", "tesseract",
                      "grobid")


def run_parser(name: str, doc: Document, cfg: CorpusConfig,
               rng: np.random.RandomState, image_degraded=False,
               text_degraded=False) -> list[np.ndarray]:
    """Simulated parse: ground truth -> parser's corruption channel.

    Resolved through the backend registry like the batch path. Channel
    backends keep the legacy single-doc rng stream (corrupt_document);
    other backends parse a batch of one."""
    from repro_torch.core import backends
    be = backends.get_backend(name)
    if isinstance(be, backends.ChannelBackend):
        return corrupt_document(doc, be.spec.channel, cfg, rng,
                                image_degraded=image_degraded,
                                text_degraded=text_degraded)
    return be.parse_batch([doc], cfg, rng, image_degraded=image_degraded,
                          text_degraded=text_degraded)[0]


def run_parser_batch(name: str, docs: list[Document], cfg: CorpusConfig,
                     rng: np.random.RandomState, image_degraded=False,
                     text_degraded=False) -> list[list[np.ndarray]]:
    """Batched ``run_parser``: dispatched through the backend registry
    (core/backends), so registered custom backends are reachable here and
    from everything built on top (engine, campaign executor). The default
    registry applies one vectorized channel over the whole batch — the
    engine's hot path (see synthetic.corrupt_documents)."""
    from repro_torch.core import backends
    return backends.get_backend(name).parse_batch(
        docs, cfg, rng, image_degraded=image_degraded,
        text_degraded=text_degraded)


# corpus mean pages: per-doc costs are page-normalized against it (§5.2)
MEAN_PAGES = 4.5


def parse_cost_s(name: str, doc: Document) -> float:
    """Per-document cost in node-seconds (page-normalized, §5.2)."""
    return float(parse_cost_batch(name, [doc])[0])


def parse_cost_batch(name: str, docs: list[Document]) -> np.ndarray:
    """Vectorized ``parse_cost_s`` -> (n,) float64 node-seconds,
    dispatched through the backend registry."""
    from repro_torch.core import backends
    return backends.get_backend(name).cost_batch(docs)


def throughput_at_nodes(name: str, n_nodes: int,
                        fs_bandwidth_Bps: float = 650e9,
                        doc_bytes: float | None = None) -> float:
    """Fig. 5 scaling model: linear in nodes, capped by (a) a backend's
    internal scale ceiling and (b) shared-filesystem bandwidth."""
    from repro_torch.core import backends
    info = backends.get_backend(name).info
    eff_nodes = min(n_nodes, info.scale_cap_nodes)
    linear = info.pdf_per_sec_node * eff_nodes
    io = (doc_bytes or info.io_bytes_per_doc)
    fs_cap = fs_bandwidth_Bps / io * 0.001   # ~0.1% of agg BW per campaign
    return min(linear, fs_cap)
