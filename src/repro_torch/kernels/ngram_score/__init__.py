from repro_torch.kernels.ngram_score.ops import ngram_bleu
from repro_torch.kernels.ngram_score.ref import ngram_bleu_ref
