"""Plain PyTorch version of the trimmed_wavg kernel (the CPU path and the
oracle `chip_smoke.py` holds the kernel to on the card)."""
import torch


def trimmed_mean_ref(x, w, trim: int):
    """Weighted coordinate trimmed mean: x (K, N), RAW weights w (K,)
    (0 = not participating) -> (N,) float32.

    Per column, `trim` (max, min) pairs are removed from the
    participants (w > 0). Each removal knocks out the FIRST (lowest
    index) occurrence of the extreme among the rows still included: the
    max first, then the min of what is left. Pair i is removed only
    while the round has n_part >= 2 i + 3 participants. The survivors'
    weighted sum is normalized by their raw weights, max(den, 1e-12).
    """
    x, w = x.float(), w.float()
    k = x.shape[0]
    part = w > 0
    inc = part[:, None].expand(x.shape)
    ridx = torch.arange(k, device=x.device)[:, None]
    n_part = part.sum()
    for i in range(trim):
        gate = n_part >= 2 * i + 3
        big = torch.where(inc, x, -torch.inf)
        is_mx = inc & (big == big.amax(0, keepdim=True))
        first = torch.where(is_mx, ridx, k).amin(0, keepdim=True)
        rem_max = is_mx & (ridx == first)
        inc_mid = inc & ~rem_max
        small = torch.where(inc_mid, x, torch.inf)
        is_mn = inc_mid & (small == small.amin(0, keepdim=True))
        first = torch.where(is_mn, ridx, k).amin(0, keepdim=True)
        rem_min = is_mn & (ridx == first)
        inc = torch.where(gate, inc & ~(rem_max | rem_min), inc)
    wk = torch.where(inc, w[:, None], 0.0)
    return (wk * x).sum(0) / torch.clamp(wk.sum(0), min=1e-12)
