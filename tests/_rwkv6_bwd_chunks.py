"""The RWKV6 backward kernel's chunked algorithm (``csrc/rwkv6_bwd.cu``),
transcribed into torch for the tests: the CPU tests hold it against
``rwkv6.rwkv6_bwd_ref`` and jax's vjp of ``repro``'s ``rwkv_ref``, the
card's tests hold the kernel against it.

It computes what the kernel computes, in the kernel's order of passes and
with the kernel's factoring of the decays; only the order of the sums
within a product differs. Per (b, h), with T cut into chunks of ``chunk``
rows (the last zero-padded: log_w 0, r = k = v = do = 0), le the inclusive
cumulative log decay within a chunk and le_C its value at the chunk's last
row:

1. the state before each chunk, S_c = exp(le_C) S_{c-1}
   + (k * exp(le_C - le))^T V, from s0;
2. the outputs' part of the state's cotangent at each chunk's end, walked
   backward from zeros, G_{c-1} = exp(le_C) G_c + (r * exp(le))^T dO, and
   the log decay summed over the later chunks (Lrest); ds0 = G_{-1} +
   exp(L_{T-1}) dS_final;
3. per chunk, from S_{c-1} and the whole cotangent at its end,
   G = G^o_c + exp(Lrest_c) dS_final: dr, dk, dv, the chunk's rows of du
   and of dlog_w.

Within a chunk, 16-row sub-chunks factor exp(le_i - le_j) (j in an earlier
sub-chunk J than i's I) as Ef_i X[I][J+1] Kfac_j, with Ef_i = exp(le_i -
LB[I]), Kfac_j = exp(LB[J+1] - le_j), X[a][b] = exp(LB[a] - LB[b]) and LB[a]
le at the row before sub-chunk a (LB[0] = 0): every exponent <= 0. Pairs
within one sub-chunk take exp(le_i - le_j) itself (the kernel: a running
product of the steps' decays).

dlog_w_t = rowsum(G_{t-1} * S_{t-1}) is, for t in a chunk,

    X[ns][0] rowsum(G * S_{c-1}) + sum_{j < t} k_j * dks_j
        + sum_{i >= t} (r_i * dr'_i - k_i * dkq_i)

with dks the state's part of dk (G v_j, decayed to row j), dkq the chunk's
own part and dr' dr without the bonus: a prefix and a suffix sum within the
chunk, no walk over T.
"""

import torch

SUB = 16


def rwkv6_bwd_chunked(r, k, v, log_w, u, s0, do, ds=None, *, chunk=32):
    """(dr, dk, dv in r's dtype; dlog_w, du, ds0 fp32), as
    ``rwkv6_bwd_ref`` returns them. ``chunk`` is a multiple of 16."""
    b, t, h, dh = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t
    f32 = dict(dtype=torch.float32, device=r.device)

    def chunks(x):      # (B, T, H, D) -> (B, H, n, C, D), zero-padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, n, chunk, h, dh).permute(0, 3, 1, 2, 4)
    rc, kc, vc, dc, lw = (chunks(x) for x in (r, k, v, do, log_w))
    uf = u.float()[None, :, None, :]                  # (1, H, 1, D)
    le = torch.cumsum(lw, dim=3)
    last = le[:, :, :, -1]                            # (B, H, n, D)
    zeros = torch.zeros((b, h, dh, dh), **f32)

    # pass 1: the state before each chunk
    states = [zeros if s0 is None else s0.float()]
    for c in range(n - 1):
        kd = kc[:, :, c] * torch.exp(last[:, :, c, None] - le[:, :, c])
        states.append(torch.exp(last[:, :, c])[..., None] * states[-1]
                      + torch.einsum("bhjd,bhje->bhde", kd, vc[:, :, c]))
    # pass 2: G^o at each chunk's end and the later chunks' log decay
    g_end, lrest = [None] * n, [None] * n
    g, lsum = zeros, torch.zeros((b, h, dh), **f32)
    for c in reversed(range(n)):
        g_end[c], lrest[c] = g, lsum
        rd = rc[:, :, c] * torch.exp(le[:, :, c])
        g = torch.exp(last[:, :, c])[..., None] * g \
            + torch.einsum("bhid,bhie->bhde", rd, dc[:, :, c])
        lsum = lsum + last[:, :, c]
    ds0 = g if ds is None else g + torch.exp(lsum)[..., None] * ds.float()

    # pass 3: each chunk on its own
    ns = chunk // SUB
    idx = torch.arange(chunk, device=r.device)
    blk = idx // SUB
    same = blk[:, None] == blk[None, :]
    below = idx[:, None] > idx[None, :]
    outs = []
    for c in range(n):
        rr, kk, vv, dd, ll = (x[:, :, c] for x in (rc, kc, vc, dc, le))
        gt = g_end[c] if ds is None else \
            g_end[c] + torch.exp(lrest[c])[..., None] * ds.float()
        sp = states[c]
        lb = torch.cat([torch.zeros_like(ll[..., :1, :]),
                        ll[..., SUB - 1::SUB, :]], dim=2)   # (B, H, ns+1, D)
        xt = torch.exp(lb[:, :, :, None] - lb[:, :, None])  # X[a][b]
        ef = torch.exp(ll - lb[:, :, blk])                  # Ef_i
        kfac = torch.exp(lb[:, :, blk + 1] - ll)            # Kfac_j
        # pairwise decays within a sub-chunk (masked before the exp)
        diff = ll[:, :, :, None] - ll[:, :, None]           # (i, j, D)
        inner = same & below
        dec = torch.where(inner[..., None], torch.exp(torch.where(
            inner[..., None], diff, torch.zeros(()))), torch.zeros(()))
        p = torch.einsum("bhie,bhje->bhij", dd, vv)         # dO V^T
        cdot = torch.diagonal(p, dim1=2, dim2=3)            # v_i . do_i
        # the scores: off-diagonal blocks factored, diagonal blocks
        # pairwise, the bonus on the diagonal
        a = torch.einsum("bhid,bhjd,bhijd->bhij", rr, kk, dec)
        dr = torch.einsum("bhij,bhjd,bhijd->bhid", p, kk, dec)
        dkq = torch.einsum("bhij,bhid,bhijd->bhjd", p, rr, dec)
        a = a + torch.diag_embed((rr * uf * kk).sum(-1))
        dr = dr + ef * xt[:, :, blk, 0] * torch.einsum(
            "bhie,bhde->bhid", dd, sp)
        for i_ in range(1, ns):
            ri = slice(i_ * SUB, (i_ + 1) * SUB)
            for j_ in range(i_):
                rj = slice(j_ * SUB, (j_ + 1) * SUB)
                xij = xt[:, :, i_, j_ + 1, None]             # (B, H, 1, D)
                rf = rr[:, :, ri] * ef[:, :, ri] * xij
                kf = kk[:, :, rj] * kfac[:, :, rj] * xij
                a[:, :, ri, rj] = torch.einsum("bhid,bhjd->bhij",
                                               rr[:, :, ri] * ef[:, :, ri],
                                               kf)
                dr[:, :, ri] += ef[:, :, ri] * torch.einsum(
                    "bhij,bhjd->bhid", p[:, :, ri, rj], kf)
                dkq[:, :, rj] += kfac[:, :, rj] * torch.einsum(
                    "bhij,bhid->bhjd", p[:, :, ri, rj], rf)
        kfull = kfac * xt[:, :, ns, blk + 1]                 # exp(le_C - le)
        dks = kfull * torch.einsum("bhje,bhde->bhjd", vv, gt)
        dv = torch.einsum("bhij,bhie->bhje", a, dd) \
            + torch.einsum("bhjd,bhde->bhje", kk * kfull, gt)
        dk = dks + dkq + uf * rr * cdot[..., None]
        du = (rr * kk * cdot[..., None]).sum(2)             # (B, H, D)
        rho = (gt * sp).sum(-1)                             # (B, H, D)
        fwd = torch.cumsum(torch.nn.functional.pad(
            kk * dks, (0, 0, 1, 0))[:, :, :-1], dim=2)      # exclusive
        back = torch.flip(torch.cumsum(torch.flip(
            rr * dr - kk * dkq, [2]), dim=2), [2])          # inclusive
        dlw = (xt[:, :, ns, 0] * rho)[:, :, None] + fwd + back
        outs.append((dr + uf * kk * cdot[..., None], dk, dv, dlw, du))

    def rows(i):        # chunk rows back to (B, T, H, D)
        x = torch.stack([o[i] for o in outs], dim=2)
        return x.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, dh)[:, :t]
    dr, dk, dv, dlw = (rows(i) for i in range(4))
    du = sum(o[4] for o in outs).sum(0)
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw, du, ds0
