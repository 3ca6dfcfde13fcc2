"""Hand-written CUDA kernels of the port's paths, one subpackage per TPU
kernel they replace:

- fast_features : the prepare stage's CLS-I features + LLM tokens
- budget_route  : the alpha-budget select + compact dispatch
- ngram_score   : the quality probe's per-document BLEU
- flash_attention: the dense LM's prefill attention (``impl="pallas"``)
- embedding_bag : the DLRM forward's field lookup (``lookup_fields``)
- segment_mm    : the GNN message-passing step (``segment_matmul``)

Each subpackage: ``csrc/*.cu`` (the kernel, with a note on the TPU
kernel it replaces and what bounds it), ``ref.py`` (the plain PyTorch
version of the same function), ``ops.py`` (the wrapper: plain version
for CPU tensors, the kernel for CUDA tensors — never a fallback from
one to the other). ``cuda_lib`` builds all sources into one library at
first launch.
"""
