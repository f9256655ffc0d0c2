"""No-repeat-ngram ban (HF ``NoRepeatNGramLogitsProcessor``), dense form.

Port of ``mmdx_tpu/decode/ngram.py:banned_ngram_mask`` (``:92``): token v is
banned at this step if the last (n-1) tokens followed by v already occur in
the sequence so far. The JAX version builds the mask with a hi/lo one-hot
matmul because TPU scatters serialize; here it is one ``scatter_``. The
sparse-id variant (``banned_follower_ids``) measured as a loss on the TPU
and is not ported.
"""
from __future__ import annotations

import torch


def banned_ngram_mask(seqs: torch.Tensor, cur_len: int, vocab_size: int,
                      ngram_size: int = 3):
    """seqs [N, Lmax] token history (positions >= cur_len are junk) ->
    bool banned mask [N, V], or None when Lmax < ngram_size."""
    n, lmax = seqs.shape
    k = ngram_size - 1
    if lmax < ngram_size:
        return None
    banned = torch.zeros((n, vocab_size + 1), dtype=torch.bool, device=seqs.device)
    # only windows whose follower lies in the history (position < cur_len)
    w = min(lmax - ngram_size + 1, cur_len - k)
    if w > 0:
        suffix = seqs[:, cur_len - k:cur_len]  # [N, k]
        windows = seqs[:, :w + k - 1].unfold(1, k, 1)  # [N, W, k]
        followers = seqs[:, k:k + w]  # [N, W]
        match = (windows == suffix[:, None, :]).all(dim=-1)
        idx = torch.where(match, followers, torch.full_like(followers, vocab_size))
        banned.scatter_(1, idx, True)
    return banned[:, :vocab_size]
