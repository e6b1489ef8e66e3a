"""NeRF positional (frequency) encoding, channels-last."""

from __future__ import annotations

import torch


def positional_encoding(
    x: torch.Tensor, n_freqs: int, include_input: bool = True
) -> torch.Tensor:
    """Frequency-encode the trailing dimension of ``x``.

    Returns ``[..., D * 2 * n_freqs (+ D)]`` with the upstream channel order
    ``[x, sin(1x), cos(1x), sin(2x), cos(2x), ...]`` (frequencies
    ``2**arange(n_freqs)``).
    """
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)  # [F]
    xb = x[..., None, :] * freqs[:, None]  # [..., F, D]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, D]
    sc = sc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc


def positional_encoding_matmul(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """:func:`positional_encoding` (``include_input=True``) as one scatter
    matrix product and masked sin / cos over the whole width: column ``c``
    is ``g_c(f_c x[..., d_c])``, the static ``P [D, De]`` holding one
    frequency-scaled 1 per column (a product by a power of two: exact) and
    masks picking identity, sin or cos.  The same values as
    :func:`positional_encoding`; the form in which the fused field kernels
    encode the sample points in their tile (``embed_in_kernel``), and their
    plain versions' encoding."""
    P, m_id, m_sin, m_cos = _encoding_matrices(x.shape[-1], n_freqs, x.dtype, x.device)
    xb = x @ P
    return m_id * xb + m_sin * torch.sin(xb) + m_cos * torch.cos(xb)


def positional_encoding_matmul_vjp(x: torch.Tensor, dembed: torch.Tensor,
                                   n_freqs: int) -> torch.Tensor:
    """The cotangent of :func:`positional_encoding_matmul` at ``x`` for the
    encoding's cotangent ``dembed``: ``dxb = dembed (m_id + m_sin cos(xb) -
    m_cos sin(xb))``, then ``dxb P^T`` (the JAX kernel's ``_embed_bwd_tile``)."""
    P, m_id, m_sin, m_cos = _encoding_matrices(x.shape[-1], n_freqs, x.dtype, x.device)
    xb = x @ P
    dxb = dembed.to(x.dtype) * (m_id + m_sin * torch.cos(xb) - m_cos * torch.sin(xb))
    return dxb @ P.t()


def _encoding_matrices(D: int, n_freqs: int, dtype, device):
    """``P [D, De]`` and the identity, sin and cos masks ``[De]`` of
    :func:`positional_encoding_matmul`."""
    De = D + 2 * n_freqs * D
    c = torch.arange(De)
    dim = torch.where(c < D, c, (c - D) % D)
    f = torch.where(c < D, 1.0, torch.exp2(((c - D) // (2 * D)).double()))
    P = torch.zeros(D, De, dtype=torch.float64)
    P[dim, c] = f
    m_id = (c < D).double()
    m_sin = ((c >= D) & (((c - D) % (2 * D)) < D)).double()
    return tuple(t.to(dtype=dtype, device=device) for t in (P, m_id, m_sin, 1.0 - m_id - m_sin))
