"""Synthetic scientific-document corpus + parser corruption channels.

Real PDFs are unavailable offline, so the benchmark substrate generates
documents with exact ground truth and models each parser as a corruption
channel over it, with per-parser severity profiles calibrated against the
paper's Tables 1-3 and Figure 3 (see DESIGN.md §2 assumption log). Every
failure mode of Fig. 1 is a parameterized channel:

  (a) whitespace injection   (b) word substitution
  (c) character scrambling   (d) character substitution (near-word)
  (e) identifier corruption  (f) LaTeX->plaintext mangling
  (g) page drop

Documents carry latent difficulty + metadata (producer/year/publisher/
category/pages); the *crossing structure* of Fig. 3 — extraction parsers
beat ViT parsers on easy documents and collapse on hard ones (scrambled
text layers), while Nougat stays flat but drops pages — is what makes
adaptive routing win, and what the router learns to detect from the
extracted text.

Token space: 0=PAD 1=BOS 2=WS 3=SCRAMBLE 4=MANGLED 5..9 reserved;
words in [10, 10+n_words); LaTeX tokens in [latex_lo, latex_hi);
identifiers (SMILES-like) in [ident_lo, ident_hi).
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD, BOS, WS, SCRAMBLE, MANGLED = 0, 1, 2, 3, 4
WORD_LO = 10


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 1000
    n_words: int = 8000
    n_latex: int = 500
    n_ident: int = 200
    min_pages: int = 1
    max_pages: int = 8
    page_tokens: int = 256
    vocab_size: int = 10000          # router-encoder vocab (>= all ids)
    seed: int = 0

    @property
    def latex_lo(self):
        return WORD_LO + self.n_words

    @property
    def ident_lo(self):
        return self.latex_lo + self.n_latex


PRODUCERS = ("pdflatex", "msword", "scanner-v1", "scanner-v2", "indesign",
             "unknown")
PUBLISHERS = ("ArXiv", "BioRxiv", "BMC", "MDPI", "MedRxiv", "Nature")
CATEGORIES = ("math", "bio", "chem", "phys", "eng", "med", "econ", "cs")


@dataclasses.dataclass
class Document:
    doc_id: int
    pages: list[np.ndarray]          # ground-truth token ids per page
    difficulty: float                # latent parse difficulty in [0, 1]
    latex_density: float
    producer: str
    publisher: str
    category: str
    year: int
    scanned: bool

    @property
    def n_pages(self):
        return len(self.pages)

    def full_text(self) -> np.ndarray:
        return np.concatenate(self.pages) if self.pages else np.zeros(0, np.int32)

    def metadata_features(self) -> np.ndarray:
        """CLS-II feature vector: producer one-hot, year (scaled), pages,
        publisher one-hot, scanned flag."""
        prod = np.eye(len(PRODUCERS))[PRODUCERS.index(self.producer)]
        pub = np.eye(len(PUBLISHERS))[PUBLISHERS.index(self.publisher)]
        return np.concatenate([
            prod, pub,
            [(self.year - 2000) / 25.0, self.n_pages / 10.0,
             float(self.scanned)],
        ]).astype(np.float32)


def generate_corpus(cfg: CorpusConfig) -> list[Document]:
    rng = np.random.RandomState(cfg.seed)
    # Zipfian word distribution (natural-language-like)
    ranks = np.arange(1, cfg.n_words + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    docs = []
    for i in range(cfg.n_docs):
        category = CATEGORIES[rng.randint(len(CATEGORIES))]
        publisher = PUBLISHERS[rng.randint(len(PUBLISHERS))]
        latex_density = float(np.clip(
            rng.beta(1.2, 6.0) + (0.15 if category in ("math", "phys", "cs")
                                  else 0.0), 0, 0.5))
        scanned = rng.rand() < 0.15
        year = int(1990 + 35 * rng.beta(3, 1.2))
        producer = (rng.choice(["scanner-v1", "scanner-v2"]) if scanned else
                    rng.choice(["pdflatex", "msword", "indesign", "unknown"],
                               p=[0.5, 0.25, 0.15, 0.1]))
        # difficulty: scans and old msword docs are harder; latex adds some
        base = rng.beta(2.0, 5.0)
        difficulty = float(np.clip(
            base + 0.45 * scanned + 0.15 * (producer == "msword")
            + 0.2 * latex_density + 0.1 * (year < 2005), 0, 1))
        n_pages = rng.randint(cfg.min_pages, cfg.max_pages + 1)
        pages = []
        for _ in range(n_pages):
            n_tok = int(cfg.page_tokens * rng.uniform(0.7, 1.3))
            words = rng.choice(cfg.n_words, size=n_tok, p=probs) + WORD_LO
            # sprinkle LaTeX spans + identifiers
            n_spans = rng.poisson(latex_density * 8)
            for _ in range(n_spans):
                s = rng.randint(0, max(n_tok - 6, 1))
                ln = rng.randint(2, 6)
                words[s:s + ln] = cfg.latex_lo + rng.randint(
                    0, cfg.n_latex, size=len(words[s:s + ln]))
            if category in ("chem", "bio", "med") and rng.rand() < 0.3:
                s = rng.randint(0, max(n_tok - 3, 1))
                words[s:s + 2] = cfg.ident_lo + rng.randint(0, cfg.n_ident, 2)
            pages.append(words.astype(np.int32))
        docs.append(Document(i, pages, difficulty, latex_density, producer,
                             publisher, category, year, scanned))
    return docs


# ---------------------------------------------------------------------------
# Corruption channels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChannelProfile:
    """Per-parser corruption severities. Rates are at difficulty=1; the
    effective rate is rate * f(difficulty) with channel-specific shaping."""

    p_ws: float = 0.0                # whitespace injection
    p_sub: float = 0.0               # word substitution
    p_scramble: float = 0.0          # char scrambling -> garbage token
    p_char: float = 0.0              # near-word substitution
    p_ident: float = 0.0             # identifier corruption
    p_latex: float = 0.0             # LaTeX span mangling
    p_page_drop: float = 0.0         # whole-page drop
    p_fail: float = 0.0              # document-level failure (empty output)
    text_layer: bool = True          # reads embedded text layer?
    difficulty_power: float = 1.0    # error ~ difficulty ** power
    flat_floor: float = 0.0          # difficulty-independent error floor


def batch_metadata_features(docs: list[Document]) -> np.ndarray:
    """Vectorized ``Document.metadata_features`` over a batch -> (n, F)."""
    n = len(docs)
    n_prod, n_pub = len(PRODUCERS), len(PUBLISHERS)
    out = np.zeros((n, n_prod + n_pub + 3), np.float32)
    if n == 0:
        return out
    rows = np.arange(n)
    out[rows, [PRODUCERS.index(d.producer) for d in docs]] = 1.0
    out[rows, n_prod + np.array([PUBLISHERS.index(d.publisher)
                                 for d in docs])] = 1.0
    out[:, -3] = np.array([(d.year - 2000) / 25.0 for d in docs])
    out[:, -2] = np.array([d.n_pages / 10.0 for d in docs])
    out[:, -1] = np.array([float(d.scanned) for d in docs])
    return out


def _channel_severity(docs: list[Document], prof: ChannelProfile,
                      image_degraded: bool, text_degraded: bool
                      ) -> np.ndarray:
    """Per-doc effective severity, mirroring the scalar rules exactly:
    text parsers suffer from degraded TEXT layers, recognition parsers
    from degraded IMAGES (paper §7.2 regimes)."""
    diff = np.array([d.difficulty for d in docs], np.float64)
    sev = prof.flat_floor + diff ** prof.difficulty_power
    if prof.text_layer:
        if text_degraded:
            sev = np.minimum(1.0, sev + 0.5)
        scanned = np.array([d.scanned for d in docs], bool)
        sev = np.where(scanned, np.minimum(1.0, sev + 0.35), sev)
    elif image_degraded:
        sev = np.minimum(1.0, sev + 0.3)
    return sev


def corrupt_documents(docs: list[Document], prof: ChannelProfile,
                      cfg: CorpusConfig, rng: np.random.RandomState,
                      image_degraded: bool = False,
                      text_degraded: bool = False) -> list[list[np.ndarray]]:
    """Batched ``corrupt_document``: apply one parser channel to a whole
    batch with one rng draw per channel over the flattened token stream
    (all pages of all docs), instead of per-doc/per-page Python loops.

    This is the engine's hot path (every doc goes through the cheap
    channel); the per-channel masks, substitutions, and whitespace
    insertion are each a single vectorized op over ~k * pages * tokens
    elements. Returns output pages per document."""
    n_docs = len(docs)
    if n_docs == 0:
        return []
    sev = _channel_severity(docs, prof, image_degraded, text_degraded)
    failed = (rng.rand(n_docs) < prof.p_fail * sev if prof.p_fail > 0
              else np.zeros(n_docs, bool))

    pages_per_doc = np.array([d.n_pages for d in docs])
    doc_of_page = np.repeat(np.arange(n_docs), pages_per_doc)
    n_pages = int(pages_per_doc.sum())
    flat_pages = [pg for d in docs for pg in d.pages]
    page_lens = np.fromiter((len(pg) for pg in flat_pages), np.int64,
                            count=n_pages)
    dropped = (rng.rand(n_pages) < prof.p_page_drop
               if prof.p_page_drop > 0 else np.zeros(n_pages, bool))
    dropped |= failed[doc_of_page]

    t = (np.concatenate(flat_pages) if n_pages else
         np.zeros(0, np.int64)).astype(np.int64)
    n = len(t)
    page_of_tok = np.repeat(np.arange(n_pages), page_lens)
    sev_tok = sev[doc_of_page[page_of_tok]]
    is_latex = (t >= cfg.latex_lo) & (t < cfg.ident_lo)
    is_ident = t >= cfg.ident_lo
    # (f) LaTeX mangling: whole spans to MANGLED
    if prof.p_latex > 0:
        fail = rng.rand(n) < prof.p_latex * (0.3 + 0.7 * sev_tok)
        t = np.where(is_latex & fail, MANGLED, t)
    # (e) identifier corruption
    if prof.p_ident > 0:
        fail = rng.rand(n) < prof.p_ident * (0.3 + 0.7 * sev_tok)
        t = np.where(is_ident & fail, MANGLED, t)
    # (b) word substitution
    if prof.p_sub > 0:
        m = rng.rand(n) < prof.p_sub * sev_tok
        t = np.where(m, rng.randint(WORD_LO, WORD_LO + cfg.n_words, size=n),
                     t)
    # (d) near-word (character) substitution
    if prof.p_char > 0:
        m = (rng.rand(n) < prof.p_char * sev_tok) & (t >= WORD_LO)
        t = np.where(m, np.bitwise_xor(t, 1), t)
    # (c) scrambling
    if prof.p_scramble > 0:
        m = rng.rand(n) < prof.p_scramble * sev_tok
        t = np.where(m, SCRAMBLE, t)
    # (a) whitespace injection (np.insert keeps each WS inside the page
    # of the token it was drawn against)
    if prof.p_ws > 0:
        m = rng.rand(n) < prof.p_ws * sev_tok
        idx = np.nonzero(m)[0]
        if len(idx):
            page_lens = page_lens + np.bincount(page_of_tok[idx],
                                                minlength=n_pages)
            t = np.insert(t, idx, WS)

    bounds = np.cumsum(page_lens)[:-1]
    pieces = np.split(t.astype(np.int32), bounds) if n_pages else []
    empty = np.zeros(0, np.int32)
    out: list[list[np.ndarray]] = []
    p = 0
    for d in docs:
        out.append([empty if dropped[p + j] else pieces[p + j]
                    for j in range(d.n_pages)])
        p += d.n_pages
    return out


def corrupt_document(doc: Document, prof: ChannelProfile, cfg: CorpusConfig,
                     rng: np.random.RandomState,
                     image_degraded: bool = False,
                     text_degraded: bool = False) -> list[np.ndarray]:
    """Apply a parser's channel to a document; returns output pages."""
    # effective severity: text parsers suffer from degraded TEXT layers,
    # recognition parsers from degraded IMAGES (paper §7.2 regimes)
    sev = prof.flat_floor + (doc.difficulty ** prof.difficulty_power)
    if prof.text_layer:
        if text_degraded:
            sev = min(1.0, sev + 0.5)
        if doc.scanned:
            sev = min(1.0, sev + 0.35)   # scans have OCR'd (noisy) layers
    else:
        if image_degraded:
            sev = min(1.0, sev + 0.3)
    if rng.rand() < prof.p_fail * sev:
        return [np.zeros(0, np.int32) for _ in doc.pages]
    out = []
    for page in doc.pages:
        if rng.rand() < prof.p_page_drop:
            out.append(np.zeros(0, np.int32))
            continue
        t = page.copy()
        n = len(t)
        is_latex = (t >= cfg.latex_lo) & (t < cfg.ident_lo)
        is_ident = t >= cfg.ident_lo
        # (f) LaTeX mangling: whole spans to MANGLED
        if prof.p_latex > 0:
            fail = rng.rand(n) < prof.p_latex * (0.3 + 0.7 * sev)
            t = np.where(is_latex & fail, MANGLED, t)
        # (e) identifier corruption
        if prof.p_ident > 0:
            fail = rng.rand(n) < prof.p_ident * (0.3 + 0.7 * sev)
            t = np.where(is_ident & fail, MANGLED, t)
        # (b) word substitution
        if prof.p_sub > 0:
            m = rng.rand(n) < prof.p_sub * sev
            t = np.where(m, rng.randint(WORD_LO, WORD_LO + cfg.n_words,
                                        size=n), t)
        # (d) near-word (character) substitution
        if prof.p_char > 0:
            m = (rng.rand(n) < prof.p_char * sev) & (t >= WORD_LO)
            t = np.where(m, np.bitwise_xor(t, 1), t)
        # (c) scrambling
        if prof.p_scramble > 0:
            m = rng.rand(n) < prof.p_scramble * sev
            t = np.where(m, SCRAMBLE, t)
        # (a) whitespace injection
        if prof.p_ws > 0:
            m = rng.rand(n) < prof.p_ws * sev
            idx = np.nonzero(m)[0]
            if len(idx):
                t = np.insert(t, idx, WS)
        out.append(t.astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# Preference oracle (stands in for the 23-expert study, §6.3)
# ---------------------------------------------------------------------------


def preference_utility(ref: np.ndarray, hyp: np.ndarray,
                       rng: np.random.RandomState,
                       doc_bleu: float | None = None) -> float:
    """Scalar 'human' utility: BLEU plus stylistic biases (humans punish
    visible garbage — scrambles/whitespace/mangles — more than BLEU does,
    and strongly punish dropped content) plus judgment noise. Calibrated so
    corr(BLEU, win-rate) ≈ 0.5 (paper: ρ̂=0.47)."""
    from repro_torch.core import metrics as M
    b = M.bleu(ref, hyp) if doc_bleu is None else doc_bleu
    hyp = np.asarray(hyp).ravel()
    n = max(len(hyp), 1)
    frac_garbage = float(np.isin(hyp, (SCRAMBLE, MANGLED)).mean()) if len(hyp) else 0.0
    frac_ws = float((hyp == WS).mean()) if len(hyp) else 0.0
    drop_pen = 1.0 if len(hyp) == 0 else 0.0
    return (b - 1.5 * frac_garbage - 0.8 * frac_ws - 0.9 * drop_pen
            + rng.normal(0, 0.18))
