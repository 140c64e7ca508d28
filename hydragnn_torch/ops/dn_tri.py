"""DimeNet++'s triplet interaction (port of hydragnn_tpu/ops/dn_tri.py):
the factored-basis op ``dimenet_triplet_mp`` and, past its widths, the
builder-backed op ``dimenet_tri_builder``.

The factored-basis op:

  sbf_t  = radial[kj(t)] * expand(cbf[t])          expand: slot l*R + r <- l
  out[e] = sum_{t: ji(t)=e, tmask(t)} x2[kj(t)] * ((sbf_t @ w1) @ w2)

``radial [E, S*R]`` is the edge-space part of the spherical basis, ``cbf
[T, S]`` the triplet-space part (models/dimenet.py
``spherical_basis_factors``); ``x2 [E, D]`` the down-projected edge
features; ``w1 [S*R, B]``, ``w2 [B, D]`` the ``lin_sbf1``/``lin_sbf2``
kernels.  Limits (the reference's gate): S <= 8, S*R <= 64, B <= 64,
D <= 64.

Two kernels, hand-written in CUDA C++ for Hopper (csrc/dn_tri.cu, built by
kernels/build.py), neither of which writes a ``[T, D]`` or ``[T, S*R]``
tensor to device memory:

- forward (the reference's ``_tri_fwd``): output rows in ``idx_ji`` order
  (one CSR range per row), recompute sbf, emb per triplet, sum
  ``x2[kj] * emb`` into the row.  Two routes by width (:func:`fwd_route`):
  route 1 (B <= 8, D a multiple of 8, the arch sweep's widths) is the
  builder forward's route-1 kernel (csrc/tri_tc.cuh: each warp on its own
  share of the rows, ``cp.async`` rings, tensor cores in 3xTF32) with the
  sbf operand formed from the gathered ``radial[kj]`` row and the
  triplet's ``cbf`` row as it is loaded; route 2 is the first design;
- backward (``_tri_vjp_bwd``): one pass in ``idx_kj`` order through
  ``perm_kj``, factored onto the rows: every triplet of row k shares
  ``radial[k]`` and ``x2[k]``, so per triplet only ``G[k, l] += cbf[t, l]
  * dout[ji(t)]`` (and ``d_cbf`` when asked) is left, the products with
  ``w1``, ``w2`` run once per row; each row k owns ``d_x2[k]`` and
  ``d_radial[k]``, ``d_cbf`` goes to each triplet's own slot, ``dw1``/``dw2``
  sum into per-block partials reduced in a fixed order (csrc/dn_tri.cu
  writes the factored form out).

The backward written out (:func:`dimenet_triplet_bwd_plain`), with
``g = dout[ji]``:

  d_emb2 = g * x2[kj];        d_x2[kj]     += g * emb2
  d_emb1 = d_emb2 @ w2^T;     d_sbf         = d_emb1 @ w1^T
  dw2    = emb1^T d_emb2;     dw1           = sbf^T d_emb1
  d_radial[kj] += d_sbf * expand(cbf);  d_cbf[t, l] = sum_r (d_sbf *
  radial[kj])[l*R + r]

Masked triplets (``tmask == 0``) sort last in both orders
(add_dimenet_extras guarantees it); they are never visited and get exactly
zero in every output and gradient (``d_cbf`` included).

The builder-backed op (the reference's fused-block builder with the
``dn_tri_builder`` spec), for S*R <= 127 and B, D <= 128:

  out[e] = sum_{t: ji(t)=e, tmask(t)} x_kj[kj(t)] * ((sbf_t @ k1) @ k2)

with ``sbf [T, S*R]`` the full per-triplet spherical basis.  Three kernels
in csrc/dn_tri_builder.cu, none of which writes a ``[T, D]`` or ``[T, B]``
tensor to device memory: the forward in ``idx_ji`` order (two routes by
width, :func:`builder_fwd_route`: tensor cores with each warp on its own
share of the rows, :func:`~hydragnn_torch.ops.aggregate.row_shares`, or
the first design); pass S in
``idx_kj`` order through ``perm_kj`` (each row k owns ``d_x_kj[k]``,
``d_sbf`` goes to each triplet's own slot; two routes,
:func:`builder_bwd_s_route`: the forward's route 1 in kj order when
``d_sbf`` is not asked for, or the first design); pass P in ``idx_ji`` order
(``dk1``, ``dk2`` in per-block partials reduced in a fixed order; two
routes, :func:`builder_bwd_p_route`: the forward's ring and products with
each warp on its own share of the rows and the weight gradients in
registers, summed in warp then block order, or the first design over
slices of B).  Its backward written out
(:func:`dimenet_tri_builder_bwd_plain`), with ``g = dout[ji]``:

  d_emb2 = g * x_kj[kj];     d_x_kj[kj] += g * emb2
  d_emb1 = d_emb2 @ k2^T;    d_sbf       = d_emb1 @ k1^T
  dk2    = emb1^T d_emb2;    dk1         = sbf^T d_emb1

A CPU tensor takes the plain PyTorch versions (the CPU path and the tests'
oracle), a CUDA tensor the kernels; a CUDA input the kernels do not take
raises.  ``LAUNCHES`` counts the kernels' launches.  Both ops are
differentiable once: a double backward raises (the force term, ROADMAP
queue A3).
"""

from __future__ import annotations

from typing import Dict

import torch

from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_torch.ops.egcl_mp import _ptr
from hydragnn_torch.ops.fused_mp import _aligned, _check_rc, _require

# the reference's gate for the factored kernel (models/dimenet.py:655-658)
TRI_S_LIMIT = 8
TRI_SR_LIMIT = 64
FACTORED_EMB_LIMIT = 64
# the builder's limits under the reference's names (ops/dn_tri.py:404-405):
# S*R lanes (one 128-lane geometry tile less its bias lane), and the basis
# and interaction embedding sizes (one lane tile)
TRI_SBF_LIMIT = 127
TRI_EMB_LIMIT = 128

LAUNCHES: Dict[str, int] = {"dimenet_triplet_mp": 0,
                            "dimenet_triplet_mp_bwd": 0,
                            "dimenet_tri_builder": 0,
                            "dimenet_tri_builder_bwd_s": 0,
                            "dimenet_tri_builder_bwd_p": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _valid(tmask, idx_kj, idx_ji, e):
    ok = ((tmask != 0) & (idx_kj >= 0) & (idx_kj < e) & (idx_ji >= 0)
          & (idx_ji < e))
    return (ok, idx_kj.clamp(0, max(e - 1, 0)).long(),
            idx_ji.clamp(0, max(e - 1, 0)).long())


def _expand(cbf, num_radial):
    return cbf.repeat_interleave(num_radial, dim=1)


def dimenet_triplet_reference(radial, x2, cbf, w1, w2, idx_kj, idx_ji,
                              tmask, num_radial):
    """The composed triplet contraction: gathers, the sbf product, the two
    matmuls, ``index_add`` at ``idx_ji``.  Differentiable under autograd
    in every float input; masked triplets give exactly zero for every
    output and gradient.  The forward kernel's plain version."""
    e, d = x2.shape
    ok, kj, ji = _valid(tmask, idx_kj, idx_ji, e)
    sbf = radial[kj] * _expand(cbf, num_radial)
    msg = x2[kj] * ((sbf @ w1) @ w2)
    msg = torch.where(ok[:, None], msg,
                      torch.zeros((), dtype=msg.dtype, device=msg.device))
    return torch.zeros((e, d), dtype=msg.dtype, device=x2.device).index_add(
        0, ji, msg)


def dimenet_triplet_bwd_plain(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask,
                              dout, num_radial):
    """The backward written out: ``(d_radial, d_x2, d_cbf, dw1, dw2)``,
    exactly zero on masked triplets.  The backward kernel's plain
    version."""
    e, d = x2.shape
    t, s = cbf.shape
    ok, kj, ji = _valid(tmask, idx_kj, idx_ji, e)
    zero = torch.zeros((), dtype=x2.dtype, device=x2.device)
    ce = _expand(cbf, num_radial)
    rad = radial[kj]
    sbf = rad * ce
    emb1 = sbf @ w1
    emb2 = emb1 @ w2
    g = torch.where(ok[:, None], dout[ji], zero)
    d_emb2 = g * x2[kj]
    d_emb1 = d_emb2 @ w2.t()
    d_sbf = d_emb1 @ w1.t()
    d_cbf = (d_sbf * rad).reshape(t, s, num_radial).sum(-1)
    d_cbf = torch.where(ok[:, None], d_cbf, zero)
    d_radial = torch.zeros_like(radial).index_add(0, kj, d_sbf * ce)
    d_x2 = torch.zeros_like(x2).index_add(0, kj, g * emb2)
    return d_radial, d_x2, d_cbf, sbf.t() @ d_emb1, emb1.t() @ d_emb2


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def check_widths(s, sr, b, d):
    if not (1 <= s <= TRI_S_LIMIT and s <= sr <= TRI_SR_LIMIT and sr % s == 0
            and 1 <= b <= FACTORED_EMB_LIMIT
            and 1 <= d <= FACTORED_EMB_LIMIT):
        raise ValueError(
            f"the dn_tri kernels take S <= {TRI_S_LIMIT}, S*R <= "
            f"{TRI_SR_LIMIT}, B <= {FACTORED_EMB_LIMIT} and D <= "
            f"{FACTORED_EMB_LIMIT}, got S={s}, S*R={sr}, B={b}, D={d}")


# the factored forward's route 1 (csrc/dn_tri.cu: tri_tc.cuh's kernel with
# the factored A operand): B up to this, D a multiple of 8
TRI_TC_B = 8


def fwd_route(s, sr, b, d):
    """The factored forward's route at these widths (inside
    :func:`check_widths`): 1 (the builder forward's route-1 kernel,
    csrc/tri_tc.cuh, with an A operand formed from the gathered radial row
    and the triplet's cbf row: tensor cores in 3xTF32, each warp on its
    own share of the rows, cp.async rings) at B <= 8 and D a multiple of 8,
    the arch sweep's (7, 42, 8, 64) among them; 2 (the first design,
    dn_tri_fwd_kernel) otherwise.  Mirrors ``hg_dn_tri_fwd_route``, which
    also checks that a block's shared memory holds route 1 (an H100's does
    at every width the op takes); a card test holds the two together."""
    del s, sr  # every S and S*R the op takes fit route 1
    return 1 if b <= TRI_TC_B and d % 8 == 0 else 2


def launch_dn_tri(op, radial, x2, cbf, w1, w2, idx_kj, idx_ji, perm,
                  row_ptr, num_radial, gout=None, want=(True,) * 4, route=0):
    """One launch of the dn_tri kernel on a precomputed CSR schedule
    ``row_ptr`` over positions: ``idx_ji`` order (``perm`` None) for the
    forward ``dimenet_triplet_mp``, ``idx_kj`` order through ``perm`` for
    the backward ``dimenet_triplet_mp_bwd``.  The forward returns ``out
    [E, D]``; the backward ``(d_radial, d_x2, d_cbf, dw1, dw2)``, each None
    where ``want`` (radial, x2, cbf, weights) says so.  The forward's
    ``route`` 0 takes the widths' own (:func:`fwd_route`); 1 or 2 asks
    for that one (the card checks time both), which the kernel refuses
    where the widths do not admit it."""
    from hydragnn_torch.kernels.build import load_library

    dev = x2.device
    e, d = x2.shape
    t, s = cbf.shape
    sr, b = w1.shape
    check_widths(s, sr, b, d)
    if sr != s * num_radial:
        raise ValueError(f"radial has {sr} lanes, expected S*R = "
                         f"{s}*{num_radial}")
    _require(radial, "radial", torch.float32, (e, sr), dev)
    _require(x2, "x2", torch.float32, (e, d), dev)
    _require(cbf, "cbf", torch.float32, (t, s), dev)
    _require(w1, "w1", torch.float32, (sr, b), dev)
    _require(w2, "w2", torch.float32, (b, d), dev)
    _require(idx_kj, "idx_kj", torch.int32, (t,), dev)
    _require(idx_ji, "idx_ji", torch.int32, (t,), dev)
    if perm is not None:
        _require(perm, "perm_kj", torch.int32, (t,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (e + 1,), dev)
    if e >= 2**31 or t >= 2**31:
        raise ValueError("the kernel indexes edges and triplets with int32")
    lib = load_library("dn_tri")
    radial, x2, cbf = _aligned(radial), _aligned(x2), _aligned(cbf)
    fwd = op == "dimenet_triplet_mp"
    out = d_rad = d_x2 = d_cbf = partial = wgrad = None
    n_parts = 0
    if fwd:
        out = torch.empty((e, d), dtype=torch.float32, device=dev)
    else:
        _require(gout, "dout", torch.float32, (e, d), dev)
        if want[0]:
            d_rad = torch.empty((e, sr), dtype=torch.float32, device=dev)
        if want[1]:
            d_x2 = torch.empty((e, d), dtype=torch.float32, device=dev)
        if want[2]:
            d_cbf = torch.zeros((t, s), dtype=torch.float32, device=dev)
        if want[3]:
            size = lib.hg_dn_tri_wgrad_size(sr, b, d)
            # at most four blocks per SM (3.5 KB a partial at S*R = 42,
            # B = 8, D = 64); the kernel's grid is the card's resident count
            n_parts = 4 * torch.cuda.get_device_properties(
                dev).multi_processor_count
            partial = torch.empty((n_parts, size), dtype=torch.float32,
                                  device=dev)
            wgrad = torch.empty((size,), dtype=torch.float32, device=dev)
    if e > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_dn_tri_f32(
                0 if fwd else 1, radial.data_ptr(), x2.data_ptr(),
                cbf.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                idx_kj.data_ptr(), idx_ji.data_ptr(), _ptr(perm),
                row_ptr.data_ptr(), _ptr(gout), _ptr(out), _ptr(d_rad),
                _ptr(d_x2), _ptr(d_cbf), _ptr(partial), _ptr(wgrad), e, s,
                num_radial, b, d, n_parts, route, stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    elif wgrad is not None:
        wgrad.zero_()
    if fwd:
        return out
    dw1 = dw2 = None
    if wgrad is not None:
        dw1 = wgrad[:sr * b].view(sr, b)
        dw2 = wgrad[sr * b:sr * b + b * d].view(b, d)
    return d_rad, d_x2, d_cbf, dw1, dw2


# ---------------------------------------------------------------------------
# the op: the kernels on a CUDA tensor, the plain versions on a CPU tensor
# ---------------------------------------------------------------------------

class _DimenetTriplet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask, perm_kj,
                num_radial):
        ctx.num_radial = num_radial
        ctx.save_for_backward(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask,
                              perm_kj)
        if not x2.is_cuda:
            return dimenet_triplet_reference(radial, x2, cbf, w1, w2, idx_kj,
                                             idx_ji, tmask, num_radial)
        e = x2.shape[0]
        return launch_dn_tri(
            "dimenet_triplet_mp", radial.contiguous(), x2.contiguous(),
            cbf.contiguous(), w1.contiguous(), w2.contiguous(), idx_kj,
            idx_ji, None, segment_offsets(idx_ji, e, tmask), num_radial)

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "dimenet_triplet_mp is not differentiable twice: its "
                "backward runs a hand-written kernel; the double backward "
                "of the energy-gradient force term comes with ROADMAP queue "
                "A3")
        (radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask,
         perm_kj) = ctx.saved_tensors
        need = ctx.needs_input_grad
        r = ctx.num_radial
        dout = dout.contiguous()
        if not x2.is_cuda:
            grads = dimenet_triplet_bwd_plain(radial, x2, cbf, w1, w2, idx_kj,
                                              idx_ji, tmask, dout, r)
        else:
            e = x2.shape[0]
            if perm_kj is None:
                perm_kj = torch.argsort(idx_kj, stable=True).to(torch.int32)
            p = perm_kj.long()
            grads = launch_dn_tri(
                "dimenet_triplet_mp_bwd", radial.contiguous(),
                x2.contiguous(), cbf.contiguous(), w1.contiguous(),
                w2.contiguous(), idx_kj, idx_ji, perm_kj,
                segment_offsets(idx_kj[p], e, tmask[p]), r, dout,
                want=(need[0], need[1], need[2], need[3] or need[4]))
        out = [None] * 10
        for i, (g, like) in enumerate(zip(grads, (radial, x2, cbf, w1, w2))):
            if need[i]:
                out[i] = g.reshape(like.shape).to(like.dtype)
        return tuple(out)


def dimenet_triplet_mp(radial, x2, cbf, w1, w2, idx_kj, idx_ji, tmask,
                       perm_kj, num_radial):
    """The factored-basis triplet contraction — the reference's signature
    and contract (hydragnn_tpu/ops/dn_tri.py:dimenet_triplet_mp).

    ``out[e] = sum_{t: idx_ji[t]=e} x2[idx_kj[t]] * ((radial[idx_kj[t]] *
    expand(cbf[t])) @ w1 @ w2)``.  ``tmask``: int, 1 = real triplet;
    ``perm_kj``: the stable argsort of ``idx_kj``; ``num_radial``: R.
    Differentiable once wrt radial, x2, cbf, w1 and w2.  Requires
    nondecreasing ``idx_ji`` with masked triplets last in both orders and
    the widths of :func:`check_widths` on the card (callers gate)."""
    return _DimenetTriplet.apply(radial, x2, cbf, w1, w2, idx_kj, idx_ji,
                                 tmask, perm_kj, num_radial)


# ---------------------------------------------------------------------------
# the builder-backed op (wide dims): plain versions
# ---------------------------------------------------------------------------

def dimenet_tri_builder_reference(x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji):
    """The composed wide-dims contraction: the sbf embedding's two matmuls,
    the ``x_kj`` gather, ``index_add`` at ``idx_ji``.  Differentiable under
    autograd in every float input; masked triplets give exactly zero for
    every output and gradient.  The forward kernel's plain version."""
    e, d = x_kj.shape
    ok, kj, ji = _valid(tmask, idx_kj, idx_ji, e)
    zero = torch.zeros((), dtype=x_kj.dtype, device=x_kj.device)
    sbf = torch.where(ok[:, None], sbf, zero)
    msg = torch.where(ok[:, None], x_kj[kj] * ((sbf @ k1) @ k2), zero)
    return torch.zeros((e, d), dtype=msg.dtype, device=x_kj.device).index_add(
        0, ji, msg)


def _builder_parts(x_kj, sbf, tmask, k1, idx_kj, idx_ji, dout):
    e = x_kj.shape[0]
    ok, kj, ji = _valid(tmask, idx_kj, idx_ji, e)
    zero = torch.zeros((), dtype=x_kj.dtype, device=x_kj.device)
    sbf = torch.where(ok[:, None], sbf, zero)
    g = torch.where(ok[:, None], dout[ji], zero)
    return kj, sbf, sbf @ k1, g


def dimenet_tri_builder_pass_s_plain(x_kj, sbf, tmask, k1, k2, idx_kj,
                                     idx_ji, dout, want_sbf=True):
    """Pass S written out: ``(d_x_kj, d_sbf)`` (``d_sbf`` None unless
    ``want_sbf``), exactly zero on masked triplets."""
    kj, _, emb1, g = _builder_parts(x_kj, sbf, tmask, k1, idx_kj, idx_ji,
                                    dout)
    d_x = torch.zeros_like(x_kj).index_add(0, kj, g * (emb1 @ k2))
    if not want_sbf:
        return d_x, None
    return d_x, ((g * x_kj[kj]) @ k2.t()) @ k1.t()


def dimenet_tri_builder_pass_p_plain(x_kj, sbf, tmask, k1, k2, idx_kj,
                                     idx_ji, dout):
    """Pass P written out: ``(dk1, dk2)``, the sums over real triplets of
    ``sbf^T d_emb1`` and ``emb1^T d_emb2``."""
    kj, sbf, emb1, g = _builder_parts(x_kj, sbf, tmask, k1, idx_kj, idx_ji,
                                      dout)
    d_emb2 = g * x_kj[kj]
    return sbf.t() @ (d_emb2 @ k2.t()), emb1.t() @ d_emb2


def dimenet_tri_builder_bwd_plain(x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji,
                                  dout):
    """The backward written out: ``(d_x_kj, d_sbf, dk1, dk2)``, exactly zero
    on masked triplets (with ``g = dout[ji]``: d_emb2 = g * x_kj[kj],
    d_x_kj[kj] += g * emb2, d_emb1 = d_emb2 @ k2^T, d_sbf = d_emb1 @ k1^T,
    dk2 = emb1^T d_emb2, dk1 = sbf^T d_emb1).  The backward kernels' plain
    version."""
    args = (x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji, dout)
    return (dimenet_tri_builder_pass_s_plain(*args)
            + dimenet_tri_builder_pass_p_plain(*args))


# ---------------------------------------------------------------------------
# the builder-backed op: kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

# the builder forward's route 1 (csrc/dn_tri_builder.cu fwd_tc_kernel):
# B and S*R up to these, D a multiple of 8
BUILDER_TC_B = 8
BUILDER_TC_SR = 64


def builder_fwd_route(sr, b, d):
    """The builder forward's route at these widths: 1 (fwd_tc_kernel:
    tensor cores in 3xTF32, each warp on its own share of the rows, cp.async
    rings) at B <= 8, S*R <= 64 and D a multiple of 8, DimeNet++'s QM9
    widths (42, 8, 128) among them; 2 (the first design, tri_rows_kernel)
    past that.  The C side (``hg_dn_tri_builder_fwd_route``) decides on
    the card and also checks that a block's shared memory holds route 1,
    which an H100's does at every width this gives; a card test holds
    the two together."""
    if b <= BUILDER_TC_B and sr <= BUILDER_TC_SR and d % 8 == 0:
        return 1
    return 2


def builder_bwd_s_route(sr, b, d, want_sbf):
    """Pass S's route: 1 (the forward's route 1 in kj order,
    fwd_tc_kernel<kPassS>) at the forward's route-1 widths when ``d_sbf``
    is not asked for, as on the training path; 2 (the first design,
    tri_rows_kernel<kPassS>) otherwise.  Mirrors
    ``hg_dn_tri_builder_bwd_s_route``; a card test holds the two
    together."""
    return 2 if want_sbf else builder_fwd_route(sr, b, d)


def builder_bwd_p_route(sr, b, d):
    """Pass P's route: 1 (wgrad_tc_kernel: the forward's ring and
    products, each warp on its own share of the ji rows, dK1 and dK2 in
    registers) at the forward's route-1 widths, B <= 8, S*R <= 64 and D a
    multiple of 8, DimeNet++'s QM9 widths (42, 8, 128) among them; 2 (the
    first design, tri_wgrad_kernel) past that.  Mirrors
    ``hg_dn_tri_builder_bwd_p_route``, which also checks that a block's
    shared memory holds route 1; a card test holds the two together."""
    return builder_fwd_route(sr, b, d)


def check_builder_widths(sr, b, d):
    if not (1 <= sr <= TRI_SBF_LIMIT and 1 <= b <= TRI_EMB_LIMIT
            and 1 <= d <= TRI_EMB_LIMIT):
        raise ValueError(
            f"the dn_tri_builder kernels take S*R <= {TRI_SBF_LIMIT}, B <= "
            f"{TRI_EMB_LIMIT} and D <= {TRI_EMB_LIMIT}, got S*R={sr}, B={b}, "
            f"D={d}")


_BUILDER_MODES = {"dimenet_tri_builder": 0, "dimenet_tri_builder_bwd_s": 1,
                  "dimenet_tri_builder_bwd_p": 2}


def launch_dn_tri_builder(op, x_kj, sbf, k1, k2, idx_kj, idx_ji, perm,
                          row_ptr, gout=None, want=(True, True), route=0):
    """One launch of a builder kernel on a precomputed CSR schedule
    ``row_ptr`` over positions: ``idx_ji`` order (``perm`` None) for the
    forward ``dimenet_tri_builder`` (returns ``out [E, D]``) and for pass P
    ``dimenet_tri_builder_bwd_p`` (returns ``(dk1, dk2)``); ``idx_kj``
    order through ``perm`` for pass S ``dimenet_tri_builder_bwd_s``
    (returns ``(d_x_kj, d_sbf)``, each None where ``want`` says so).
    ``route`` (pass P): 0 takes the widths' own
    (:func:`builder_bwd_p_route`), 1 or 2 asks for that one (the card
    checks time the first design beside route 1)."""
    from hydragnn_torch.kernels.build import load_library

    dev = x_kj.device
    e, d = x_kj.shape
    t, sr = sbf.shape
    b = k1.shape[1]
    check_builder_widths(sr, b, d)
    mode = _BUILDER_MODES[op]
    if route not in (0, 1, 2) or (route and mode != 2) or (
            route == 1 and builder_bwd_p_route(sr, b, d) != 1):
        raise ValueError(f"{op} takes route 0, or for pass P 2, or 1 at its "
                         f"widths; got {route} at S*R={sr}, B={b}, D={d}")
    _require(x_kj, "x_kj", torch.float32, (e, d), dev)
    _require(sbf, "sbf", torch.float32, (t, sr), dev)
    _require(k1, "k1", torch.float32, (sr, b), dev)
    _require(k2, "k2", torch.float32, (b, d), dev)
    _require(idx_kj, "idx_kj", torch.int32, (t,), dev)
    _require(idx_ji, "idx_ji", torch.int32, (t,), dev)
    if mode == 1:
        _require(perm, "perm_kj", torch.int32, (t,), dev)
    elif perm is not None:
        raise ValueError(f"{op} runs in idx_ji order: no permutation")
    _require(row_ptr, "row_ptr", torch.int32, (e + 1,), dev)
    if mode:
        _require(gout, "dout", torch.float32, (e, d), dev)
    if e >= 2**31 or t >= 2**31:
        raise ValueError("the kernel indexes edges and triplets with int32")
    lib = load_library("dn_tri_builder")
    x_kj, sbf = _aligned(x_kj), _aligned(sbf)
    if gout is not None:
        gout = _aligned(gout)
    out = d_sbf = partial = wgrad = None
    n_parts = 0
    if mode == 0:
        out = torch.empty((e, d), dtype=torch.float32, device=dev)
    elif mode == 1:
        if want[0]:
            out = torch.empty((e, d), dtype=torch.float32, device=dev)
        if want[1]:
            d_sbf = torch.zeros((t, sr), dtype=torch.float32, device=dev)
    else:
        size = lib.hg_dn_tri_builder_wgrad_size(sr, b, d)
        # four blocks per SM in all (route 2: shared between the slices of
        # B; route 1 runs one block per SM)
        n_parts = 4 * torch.cuda.get_device_properties(
            dev).multi_processor_count
        partial = torch.empty((n_parts, size), dtype=torch.float32,
                              device=dev)
        wgrad = torch.empty((size,), dtype=torch.float32, device=dev)
    if e > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_dn_tri_builder_f32(
                mode, x_kj.data_ptr(), sbf.data_ptr(), k1.data_ptr(),
                k2.data_ptr(), idx_kj.data_ptr(), idx_ji.data_ptr(),
                _ptr(perm), row_ptr.data_ptr(), _ptr(gout), _ptr(out),
                _ptr(d_sbf), _ptr(partial), _ptr(wgrad), e, sr, b, d,
                n_parts, route, stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    elif wgrad is not None:
        wgrad.zero_()
    if mode == 0:
        return out
    if mode == 1:
        return out, d_sbf
    return (wgrad[:sr * b].view(sr, b),
            wgrad[sr * b:sr * b + b * d].view(b, d))


# ---------------------------------------------------------------------------
# the builder-backed op: the kernels on a CUDA tensor, the plain versions on
# a CPU tensor
# ---------------------------------------------------------------------------

class _DimenetTriBuilder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji, perm_kj):
        ctx.save_for_backward(x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji,
                              perm_kj)
        if not x_kj.is_cuda:
            return dimenet_tri_builder_reference(x_kj, sbf, tmask, k1, k2,
                                                 idx_kj, idx_ji)
        e = x_kj.shape[0]
        return launch_dn_tri_builder(
            "dimenet_tri_builder", x_kj.contiguous(), sbf.contiguous(),
            k1.contiguous(), k2.contiguous(), idx_kj, idx_ji, None,
            segment_offsets(idx_ji, e, tmask))

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "dimenet_tri_builder is not differentiable twice: its "
                "backward runs hand-written kernels; the double backward "
                "of the energy-gradient force term comes with ROADMAP queue "
                "A3")
        (x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji,
         perm_kj) = ctx.saved_tensors
        need = ctx.needs_input_grad
        dout = dout.contiguous()
        d_x = d_sbf = dk1 = dk2 = None
        if not x_kj.is_cuda:
            args = (x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji, dout)
            if need[0] or need[1]:
                d_x, d_sbf = dimenet_tri_builder_pass_s_plain(
                    *args, want_sbf=need[1])
            if need[3] or need[4]:
                dk1, dk2 = dimenet_tri_builder_pass_p_plain(*args)
        else:
            e = x_kj.shape[0]
            x_c, sbf_c = x_kj.contiguous(), sbf.contiguous()
            k1_c, k2_c = k1.contiguous(), k2.contiguous()
            if need[0] or need[1]:
                if perm_kj is None:
                    perm_kj = torch.argsort(idx_kj, stable=True).to(
                        torch.int32)
                p = perm_kj.long()
                d_x, d_sbf = launch_dn_tri_builder(
                    "dimenet_tri_builder_bwd_s", x_c, sbf_c, k1_c, k2_c,
                    idx_kj, idx_ji, perm_kj,
                    segment_offsets(idx_kj[p], e, tmask[p]), dout,
                    want=(need[0], need[1]))
            if need[3] or need[4]:
                dk1, dk2 = launch_dn_tri_builder(
                    "dimenet_tri_builder_bwd_p", x_c, sbf_c, k1_c, k2_c,
                    idx_kj, idx_ji, None, segment_offsets(idx_ji, e, tmask),
                    dout)
        out = [None] * 8
        for i, g, like in ((0, d_x, x_kj), (1, d_sbf, sbf), (3, dk1, k1),
                           (4, dk2, k2)):
            if need[i]:
                out[i] = g.reshape(like.shape).to(like.dtype)
        return tuple(out)


def dimenet_tri_builder(x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji, perm_kj):
    """The builder-backed triplet contraction — the reference's signature
    and contract (hydragnn_tpu/ops/dn_tri.py:dimenet_tri_builder).

    ``out[e] = sum_{t: ji(t)=e, tmask(t)} x_kj[kj(t)] * ((sbf_t @ k1) @
    k2)``.  ``tmask``: int, 1 = real triplet; ``perm_kj``: the stable
    argsort of ``idx_kj``.  Differentiable once wrt x_kj, sbf, k1 and k2.
    Requires nondecreasing ``idx_ji`` with masked triplets last in both
    orders, and S*R <= TRI_SBF_LIMIT, basis and interaction embedding
    sizes <= TRI_EMB_LIMIT on the card (callers gate)."""
    return _DimenetTriBuilder.apply(x_kj, sbf, tmask, k1, k2, idx_kj, idx_ji,
                                    perm_kj)
