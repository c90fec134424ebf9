"""Phase-space forms of a stride-1 SAME conv (counterpart of
``food101_sr_tpu/ops/subpixel_conv.py``), on (N, C, H, W) tensors and
OIHW weights.

The SR tails end in ``conv9x9(64 -> 3)`` at HR resolution. The same
convolution can be computed in phase form:

    out = pixel_shuffle( conv_{k'}( space_to_depth(x, r), K' ), r )

where the r*r spatial phases of input and output become channels: the
contraction grows to (r*r*cin -> r*r*cout) over a small ``~k/r`` stencil
at LR resolution. ``phase_conv2d`` reads its input already in
pixel-shuffle layout, so a whole upsample tail runs at LR resolution and
one shuffle materializes the HR image at the very end (``phase_tail`` of
the nets); ``phase_conv2d_grouped`` is its polyphase split, one
minimal-window conv per output phase.

K' is a re-indexing of the HR conv's weight with zero fill: one gather
from the OIHW weight, through a flat index built once per shape from the
JAX package's static maps (numpy) and kept on the weight's device; its
backward is a gather through the inverse index, deterministic. The
parameters, the state_dict and the gradients stay the HR conv's. In
float32 the phase forms compute the direct conv's sums in another order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .pixel_shuffle import pixel_shuffle
from .tracing import outside_trace


@functools.lru_cache(maxsize=32)
def _phase_index_maps(k: int, r: int):
    """Static maps of the rearrangement: for output phase p and tap q of
    the decomposed conv reading input sub-phase s, the HR kernel tap is
    ``d = r*q + s - p + pad``, valid iff 0 <= d < k. Returns (qs, d
    clipped, valid), indexed [q, s, p]."""
    pad = (k - 1) // 2
    q_lo = -int(np.floor((pad + r - 1) / r))
    q_hi = int(np.floor((k - 1 + r - 1 - pad) / r))
    qs = np.arange(q_lo, q_hi + 1)
    s = np.arange(r)
    p = np.arange(r)
    d = qs[:, None, None] * r + s[None, :, None] - p[None, None, :] + pad
    valid = (d >= 0) & (d < k)
    return qs, np.clip(d, 0, k - 1), valid


def _hwio_index(k: int, cin: int, cout: int, ohwi: bool) -> np.ndarray:
    """[k, k, cin, cout]: the flat offset of each HWIO kernel entry in the
    weight's memory, OIHW, or OHWI for a channels-last weight (the JAX
    package's gathers, run on these offsets, give the source of every
    entry of the rearranged kernel)."""
    a, b, i, o = np.meshgrid(np.arange(k), np.arange(k), np.arange(cin),
                             np.arange(cout), indexing="ij")
    if ohwi:
        return ((o * k + a) * k + b) * cin + i
    return ((o * cin + i) * k + a) * k + b


@functools.lru_cache(maxsize=64)
def _phase_source(k: int, r: int, cin: int, cout: int, ohwi: bool,
                  ps_in: bool, out_perm, in_map) -> np.ndarray:
    """Flat source (in the weight's memory order) of each entry of the
    dense K' (OIHW), with ``k*k*cin*cout`` for a structural zero: the JAX
    ``_phase_kernel``'s steps on offsets instead of values."""
    kernel = _hwio_index(k, cin, cout, ohwi)
    zero = k * k * cin * cout
    qs, dmap, valid = _phase_index_maps(k, r)
    nq = len(qs)
    dy = dmap[:, None, :, None, :, None]
    dx = dmap[None, :, None, :, None, :]
    vy = valid[:, None, :, None, :, None]
    vx = valid[None, :, None, :, None, :]
    kp = kernel[dy, dx]                           # [qy,qx,sy,sx,py,px,i,c]
    kp = np.where((vy & vx)[..., None, None], kp, zero)
    if ps_in:  # input channels (i, sy, sx)
        kp = kp.transpose(0, 1, 6, 2, 3, 7, 4, 5)
    else:      # input channels (sy, sx, i)
        kp = kp.transpose(0, 1, 2, 3, 6, 7, 4, 5)
    kp = kp.reshape(nq, nq, r * r * cin, cout * r * r)  # out = (c, py, px)
    if in_map is not None:
        if not ps_in:
            raise ValueError("in_map needs pixel-shuffle input (ps_in)")
        kp = kp[:, :, np.asarray(in_map), :]
    if out_perm is not None:
        kp = kp[..., np.asarray(out_perm)]
    return np.ascontiguousarray(kp.transpose(3, 2, 0, 1))


@functools.lru_cache(maxsize=64)
def _grouped_windows(k: int, r: int):
    """Per-output-phase minimal tap windows: ``(pad, wins)`` with
    ``wins[p] = (q_lo_p, q_hi_p)``. The dense K' pads every phase to the
    union window with zero taps; split by output phase, none is
    multiplied."""
    pad = (k - 1) // 2
    wins = []
    for p in range(r):
        qs = [q for q in range(-k - 1, k + 2)
              if any(0 <= q * r + s - p + pad < k for s in range(r))]
        wins.append((min(qs), max(qs)))
    return pad, tuple(wins)


@functools.lru_cache(maxsize=256)
def _grouped_source(k: int, r: int, cin: int, cout: int, ohwi: bool,
                    py: int, px: int, in_map) -> np.ndarray:
    """Flat source of K'_p (OIHW) for output phase (py, px): the JAX
    ``_grouped_kernel``'s steps on offsets."""
    kernel = _hwio_index(k, cin, cout, ohwi)
    zero = k * k * cin * cout
    pad, wins = _grouped_windows(k, r)
    (qly, qhy), (qlx, qhx) = wins[py], wins[px]
    qy = np.arange(qly, qhy + 1)
    qx = np.arange(qlx, qhx + 1)
    s = np.arange(r)
    dy = qy[:, None] * r + s[None, :] - py + pad
    dx = qx[:, None] * r + s[None, :] - px + pad
    vy, vx = (dy >= 0) & (dy < k), (dx >= 0) & (dx < k)
    kp = kernel[np.clip(dy, 0, k - 1)[:, None, :, None],
                np.clip(dx, 0, k - 1)[None, :, None, :]]  # [qy,qx,sy,sx,i,c]
    kp = np.where((vy[:, None, :, None] & vx[None, :, None, :])
                  [..., None, None], kp, zero)
    kp = kp.transpose(0, 1, 4, 2, 3, 5)                    # [qy,qx,i,sy,sx,c]
    kp = kp.reshape(len(qy), len(qx), r * r * cin, cout)
    if in_map is not None:
        kp = kp[:, :, np.asarray(in_map), :]
    return np.ascontiguousarray(kp.transpose(3, 2, 0, 1))


def _inverse(src: np.ndarray, n: int) -> np.ndarray:
    """(n, m): for each of the ``n`` weight entries, the flat positions of
    the rearranged kernel that read it (m = the most any entry has), the
    rest padded with ``src.size``."""
    flat = src.reshape(-1)
    pos = np.flatnonzero(flat < n)
    order = pos[np.argsort(flat[pos], kind="stable")]
    counts = np.bincount(flat[pos], minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(order.size) - np.repeat(starts, counts)
    inv = np.full((n, int(counts.max())), flat.size, dtype=np.int64)
    inv[flat[order], rank] = order
    return inv


@functools.lru_cache(maxsize=256)
def _device_index(source_fn, args: tuple, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``source_fn(*args)`` and its inverse (:func:`_inverse`) as int64
    tensors on ``device``, made once (outside inference mode, so that a
    later differentiated forward may use them, and outside any trace, so
    that a first call under ``torch.export`` caches real tensors)."""
    src = source_fn(*args)
    n = args[0] * args[0] * args[2] * args[3]
    with outside_trace(), torch.inference_mode(False):
        return (torch.from_numpy(src).to(device),
                torch.from_numpy(_inverse(src, n)).to(device))


class _Gather(torch.autograd.Function):
    """``cat([flat, 0])[idx]``, whose backward gathers too: each entry's
    gradient is the sum, in a fixed order, of the positions ``inv`` lists
    for it. The gather's own backward (an ``index_put_`` that
    accumulates) sums in an order that changes from run to run on the
    CPU and sorts on CUDA; this one is deterministic on both."""

    @staticmethod
    def forward(ctx, flat, idx, inv):
        ctx.inv, ctx.n = inv, idx.numel()
        return torch.cat([flat, flat.new_zeros(1)])[idx]

    @staticmethod
    def backward(ctx, g):
        g = torch.cat([g.reshape(-1), g.new_zeros(1)])
        return g[ctx.inv].sum(dim=1), None, None


def _gather(weight: torch.Tensor, source_fn, *args) -> torch.Tensor:
    """The rearranged kernel: ``weight`` (OIHW shape) read in its own
    memory order (OIHW, or OHWI when channels-last) through the flat index
    ``source_fn`` gives for its shape, a zero where the index is one past
    the last entry. Reading the memory as it lies keeps the flatten a
    view, so the weight's gradient comes back in the weight's own layout
    (fused optimizers on CUDA take no other)."""
    o, i, k, _ = weight.shape
    ohwi = (not weight.is_contiguous()
            and weight.is_contiguous(memory_format=torch.channels_last))
    idx, inv = _device_index(source_fn, (k, *args[:1], i, o, ohwi,
                                         *args[1:]), weight.device)
    mem = weight.permute(0, 2, 3, 1) if ohwi else weight
    return _Gather.apply(mem.reshape(-1), idx, inv)


def _phase_kernel(weight: torch.Tensor, r: int, ps_in: bool,
                  out_perm=None, in_map=None) -> torch.Tensor:
    """The HR conv's OIHW ``weight`` in dense phase form: (r*r*cout,
    r*r*cin, nq, nq), input channels (sy, sx, i), or (i, sy, sx) when
    ``ps_in`` (pixel-shuffle layout); output channels in pixel-shuffle
    layout (c, py, px), re-indexed by ``out_perm`` (``new[j] =
    old[out_perm[j]]``). ``in_map`` (ps_in only) gives each actual input
    channel's canonical pixel-shuffle index."""
    return _gather(weight, _phase_source, r, ps_in,
                   None if out_perm is None else tuple(out_perm),
                   None if in_map is None else tuple(in_map))


def _grouped_kernel(weight: torch.Tensor, r: int, py: int, px: int,
                    in_map=None) -> torch.Tensor:
    """K'_p for one output phase (py, px): (cout, r*r*cin, nqy, nqx),
    input channels canonical (i, sy, sx) unless ``in_map`` says where each
    actual channel sits."""
    return _gather(weight, _grouped_source, r, py, px,
                   None if in_map is None else tuple(in_map))


def _conv_window(z: torch.Tensor, kp: torch.Tensor, bias, pads
                 ) -> torch.Tensor:
    """``F.conv2d`` with per-side paddings ``((top, bottom), (left,
    right))``, any of which may be negative: the conv runs with the
    larger of each pair (at least 0) on both sides and the output is
    cropped back to the asymmetric window."""
    (ty, by), (tx, bx) = pads
    py, px = max(ty, by, 0), max(tx, bx, 0)
    y = F.conv2d(z, kp, bias, padding=(py, px))
    h = z.shape[2] + ty + by - (kp.shape[2] - 1)
    w = z.shape[3] + tx + bx - (kp.shape[3] - 1)
    oy, ox = py - ty, px - tx
    if (oy, ox, h, w) == (0, 0, y.shape[2], y.shape[3]):
        return y
    return y[:, :, oy:oy + h, ox:ox + w]


def _phase_conv(z: torch.Tensor, weight: torch.Tensor, bias, r: int,
                ps_in: bool, out_perm=None, in_map=None) -> torch.Tensor:
    """The decomposed conv itself, phase-space input and output."""
    qs, _, _ = _phase_index_maps(weight.shape[2], r)
    kp = _phase_kernel(weight, r, ps_in, out_perm, in_map).to(z.dtype)
    b = None
    if bias is not None:
        b = bias.repeat_interleave(r * r)
        if out_perm is not None:
            b = b[list(out_perm)]
        b = b.to(z.dtype)
    lo, hi = -int(qs[0]), int(qs[-1])
    return _conv_window(z, kp, b, ((lo, hi), (lo, hi)))


def subpixel_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, r: int
                    ) -> torch.Tensor:
    """SAME stride-1 conv of ``x`` (N, cin, H, W), H and W divisible by
    ``r``, with the OIHW ``weight`` (odd k) and ``bias`` (or None),
    computed by r-phase decomposition: space-to-depth, the phase conv,
    pixel shuffle."""
    n, cin, h, w = x.shape
    z = x.permute(0, 2, 3, 1).reshape(n, h // r, r, w // r, r, cin)
    z = z.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * cin)
    y = _phase_conv(z.permute(0, 3, 1, 2), weight, bias, r, ps_in=False)
    return pixel_shuffle(y, r)


def phase_conv2d(z: torch.Tensor, weight: torch.Tensor, bias, r: int,
                 out_perm=None, shuffle_out: bool = False,
                 in_map=None) -> torch.Tensor:
    """``conv(pixel_shuffle(z, r), weight)`` without materializing the
    shuffle. ``z`` is (N, r*r*cin, H, W) in pixel-shuffle channel layout;
    the result is the conv's HR output in pixel-shuffle layout (N,
    r*r*cout, H, W), or with ``shuffle_out`` the HR image itself.
    ``out_perm`` re-indexes the output channels and ``in_map`` folds a
    producer's layout into the kernel gather (see ``_phase_kernel``)."""
    y = _phase_conv(z, weight, bias, r, ps_in=True, out_perm=out_perm,
                    in_map=in_map)
    return pixel_shuffle(y, r) if shuffle_out else y


def phase_conv2d_grouped(z: torch.Tensor, weight: torch.Tensor, bias,
                         r: int, in_map=None) -> torch.Tensor:
    """Polyphase split of :func:`phase_conv2d`: one minimal-window conv
    per output phase, concatenated in GROUPED layout ``(py, px, c)``
    (channel ``(py*r + px)*cout + c``); the consumer folds that layout
    into its own gather (:func:`grouped_out_map`). The windows are
    asymmetric (``_conv_window`` pads and crops)."""
    _, wins = _grouped_windows(weight.shape[2], r)
    b = None if bias is None else bias.to(z.dtype)
    outs = []
    for py in range(r):
        for px in range(r):
            kp = _grouped_kernel(weight, r, py, px, in_map).to(z.dtype)
            (qly, qhy), (qlx, qhx) = wins[py], wins[px]
            outs.append(_conv_window(z, kp, b, ((-qly, qhy), (-qlx, qhx))))
    return torch.cat(outs, dim=1)


@functools.lru_cache(maxsize=64)
def grouped_out_map(cout_hr: int, r_in: int, s: int = 2):
    """Canonical pixel-shuffle index (at ``r_in*s``) of each channel a
    grouped x``s`` up stage emits: channel j factors as (py, px, c, by,
    bx), HR position ``(lr*r_in + P)*s + b``, so the accumulated phase is
    ``P*s + b`` per axis. The NEXT phase conv's ``in_map``."""
    c = cout_hr // (s * s)
    r_new = r_in * s
    py, px, cc, by, bx = np.meshgrid(
        np.arange(r_in), np.arange(r_in), np.arange(c), np.arange(s),
        np.arange(s), indexing="ij")
    m = (cc * r_new * r_new + (py * s + by) * r_new + (px * s + bx))
    return tuple(int(v) for v in m.reshape(-1))


def phase_major_shuffle(y: torch.Tensor, r: int) -> torch.Tensor:
    """pixel_shuffle for GROUPED layout (channel ``(py*r + px)*c + cc``):
    the HR image after a grouped output conv."""
    n, rrc, h, w = y.shape
    c = rrc // (r * r)
    t = y.permute(0, 2, 3, 1).reshape(n, h, w, r, r, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c)
    return t.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=32)
def merge_phase_perm(cout_hr: int, r_in: int, s: int = 2):
    """Output-channel permutation restoring canonical pixel-shuffle layout
    after a phase-space x``s`` stage computed at ``r_in`` phases: ``new[j]
    = raw[src[j]]`` (a tuple)."""
    c = cout_hr // (s * s)
    src = np.arange(cout_hr * r_in * r_in).reshape(c, s, s, r_in, r_in)
    src = src.transpose(0, 3, 1, 4, 2).reshape(-1)
    return tuple(int(v) for v in src)
