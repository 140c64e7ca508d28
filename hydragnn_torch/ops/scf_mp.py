"""SchNet's fused edge pipeline (port of hydragnn_tpu/ops/scf_mp.py with
the ``scf`` spec of hydragnn_tpu/ops/fused_block.py).

  filt_e = (ssp(rbf_e @ W0 + b0) @ W1 + b1) * cm_e
  out[n] = sum_{e: recv[e]=n} h[send_e] * filt_e

Three kernels, hand-written in CUDA C++ for Hopper (csrc/scf_mp.cu, built
by kernels/build.py), none of which writes an ``[E, F]`` tensor to device
memory:

- forward (the reference's ``_fused_fwd``): receiver order, recompute the
  filter MLP per edge tile, multiply by ``h[send]``, sum into the rows.
  Two routes by width (:func:`fwd_route`): route 1 (F a multiple of 8 up
  to 256, G <= 64, the wide SchNet's among them) runs one block per SM on
  a share of the rows (:func:`~hydragnn_torch.ops.aggregate.row_shares`),
  64-edge tiles, both products on the tensor cores in 3xTF32 and the
  weights streamed through a ring of 32-row chunks; route 2 is the first
  design (CUDA cores, W1 read column by column per 32-edge tile);
- pass P (``_bwd_p_kernel``): receiver order, the grid split into edge
  shares and slices of the filter columns (:func:`pass_p_plan`); each
  block recomputes its slice of the filter MLP and keeps its slice of the
  weight grads dW0/db0/dW1/db1 on chip over its whole share (products on
  the tensor cores in 3xTF32), writes it once into its part's partial in
  the packed layout, and a fixed-order reduction sums the parts; the
  per-edge drbf/dcm are summed over the slices in order;
- pass S (``_bwd_s_kernel``): sender order (``sender_perm``), recompute,
  ``dh[n] = sum_{e: send[e]=n} g[recv[e]] * filt_e``.  It is the forward
  kernel, either route, with the roles swapped.

The reference derives its backward with ``jax.vjp`` inside the kernel;
here it is written out by hand (see :func:`scf_pass_p_plain`):

  dfilt = g[recv] * h[send];  dcm = sum_f dfilt * f2;  df2 = dfilt * cm
  db1 = sum_e df2;  dW1 = a^T df2  (a = ssp(t0))
  dt0 = (df2 @ W1^T) * sigmoid(t0);  db0 = sum_e dt0;  dW0 = rbf^T dt0
  drbf = dt0 @ W0^T

Layouts follow the reference: ``w0 [G, F]`` and ``w1 [F, F]`` are
``[in, out]`` (pass ``Linear.weight.t()``; autograd carries the grads back
to the Linear).  Masked edges (``em == 0``) must carry ``cm == 0`` and
sort last in both edge orderings (collate guarantees both); they are never
visited and get exactly zero for every grad, dcm included.

Each leaf takes a CPU tensor to its plain PyTorch version (the CPU path
and the tests' oracle) and a CUDA tensor to its kernel; a CUDA input the
kernel does not take raises.  ``LAUNCHES`` counts kernel launches per
kernel.  :func:`scf_edge_pipeline_plain` is the composed version (filter
MLP, gather, multiply, ``index_add_``) under autograd: the reference the
kernels are held to.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_torch.ops.fused_mp import _aligned, _check_rc, _require

# the reference's structural limits (ops/scf_mp.py, models/schnet.py gate)
SCF_F_LIMIT = 1024
SCF_G_LIMIT = 127

# the forward's and pass S's route 1 (csrc/scf_mp.cu scf_fg_tc_kernel): F a
# multiple of 8 up to SCF_TC_F, G up to SCF_TC_G; its edges per tile and
# weight rows per ring chunk (kTcM, kTcKC)
SCF_TC_F = 256
SCF_TC_G = 64
SCF_TC_TILE = 64
SCF_TC_CHUNK = 32

# bytes the pass-P weight-grad partials (one per edge share) may take
_PARTIAL_BUDGET = 256 << 20

LAUNCHES: Dict[str, int] = {
    "scf_edge_pipeline": 0,
    "scf_edge_pipeline_pass_p": 0,
    "scf_edge_pipeline_pass_s": 0,
}

_LN2 = math.log(2.0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ssp(x):
    return F.softplus(x) - _LN2


def _valid_edges(em, senders, receivers, n):
    ok = (em != 0) & (senders >= 0) & (senders < n) & (receivers >= 0) \
        & (receivers < n)
    return ok, senders.clamp(0, n - 1).long(), receivers.clamp(0, n - 1).long()


def _filter(rbf, cm, w0, b0, w1, b1):
    return (_ssp(rbf.float() @ w0.float() + b0.float()) @ w1.float()
            + b1.float()) * cm.float()[:, None]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def scf_edge_pipeline_plain(h, rbf, cm, em, w0, b0, w1, b1, senders,
                            receivers):
    """The composed op: filter MLP, gather, multiply, ``index_add_``.
    Differentiable under autograd in every float input; the forward
    kernel's plain version."""
    n, f = h.shape
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    msgs = h[send].float() * _filter(rbf, cm, w0, b0, w1, b1)
    msgs = torch.where(ok[:, None], msgs, torch.zeros_like(msgs))
    out = torch.zeros((n, f), dtype=torch.float32, device=h.device)
    return out.index_add(0, recv, msgs).to(h.dtype)


def scf_pass_p_plain(h, g, rbf, cm, em, w0, b0, w1, b1, senders, receivers):
    """Pass P written out: ``(dw0, db0, dw1, db1, drbf, dcm)`` in float32,
    zero on masked edges."""
    n = h.shape[0]
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    v = ok[:, None]
    rbf, w0, w1 = rbf.float(), w0.float(), w1.float()
    t0 = rbf @ w0 + b0.float()
    a = _ssp(t0)
    f2 = a @ w1 + b1.float()
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    dfilt = torch.where(v, g.float()[recv] * h.float()[send], zero)
    dcm = (dfilt * f2).sum(1)
    df2 = dfilt * cm.float()[:, None]
    dt0 = (df2 @ w1.t()) * torch.sigmoid(t0)
    return (rbf.t() @ dt0, dt0.sum(0), a.t() @ df2, df2.sum(0),
            torch.where(v, dt0 @ w0.t(), zero), torch.where(ok, dcm, zero))


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_widths(f, g):
    if f > SCF_F_LIMIT or g > SCF_G_LIMIT:
        raise ValueError(
            f"the scf kernels take num_filters <= {SCF_F_LIMIT} and "
            f"num_gaussians <= {SCF_G_LIMIT}, got F={f}, G={g}")


def _weights(w0, b0, w1, b1, f, g, dev):
    w0, b0, w1, b1 = (t.contiguous() for t in (w0, b0, w1, b1))
    _require(w0, "w0", torch.float32, (g, f), dev)
    _require(b0, "b0", torch.float32, (f,), dev)
    _require(w1, "w1", torch.float32, (f, f), dev)
    _require(b1, "b1", torch.float32, (f,), dev)
    return w0, b0, w1, b1


def fwd_route(f, g):
    """The forward's and pass S's route at these widths: 1
    (scf_fg_tc_kernel: products on the tensor cores in 3xTF32, the weights
    streamed through a ring of 32-row chunks, one block per SM on a share
    of the rows, :func:`~hydragnn_torch.ops.aggregate.row_shares`) at F a
    multiple of 8 up to 256 and G <= 64, the wide SchNet's (256, 50)
    among them; 2 (the first design, scf_filter_gather_kernel) past that,
    up to the op's limits.  The C side (``hg_scf_fwd_route``) decides on
    the card and also checks that a block's shared memory holds route 1,
    which an H100's does at every width this gives; a card test holds the
    two together."""
    return 1 if f % 8 == 0 and f <= SCF_TC_F and 1 <= g <= SCF_TC_G else 2


def launch_scf_filter_gather(x, rbf, cm, w0, b0, w1, b1, gidx, rowid, perm,
                             row_ptr, op, route=0):
    """One launch of the filter-gather kernel: ``out[r] = sum over the CSR
    range of row r (positions, mapped to edge ids through ``perm`` when
    given) of x[gidx[e]] * filt_e``.  The forward is (x=h, gidx=senders,
    rowid=receivers, no perm); pass S is (x=g, gidx=receivers,
    rowid=senders, perm=sender_perm).  ``route`` 0 takes the widths' own
    (:func:`fwd_route`); 1 or 2 asks for that one (the card checks time
    both), which the kernel refuses where the widths do not admit it.
    Returns a new float32 [N, F]."""
    from hydragnn_torch.kernels.build import load_library

    dev = x.device
    n, f = x.shape
    e, g = rbf.shape
    _check_widths(f, g)
    _require(x, "x", torch.float32, (n, f), dev)
    _require(rbf, "rbf", torch.float32, (e, g), dev)
    _require(cm, "cm", torch.float32, (e,), dev)
    _require(gidx, "gather ids", torch.int32, (e,), dev)
    _require(rowid, "row ids", torch.int32, (e,), dev)
    if perm is not None:
        _require(perm, "sender_perm", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    w0, b0, w1, b1 = _weights(w0, b0, w1, b1, f, g, dev)
    x, rbf, w0, w1 = (_aligned(t) for t in (x, rbf, w0, w1))
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out
    lib = load_library("scf_mp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_scf_filter_gather_f32(
            x.data_ptr(), rbf.data_ptr(), cm.data_ptr(), gidx.data_ptr(),
            rowid.data_ptr(), None if perm is None else perm.data_ptr(),
            row_ptr.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), out.data_ptr(), n, f, g, route, stream)
    _check_rc(rc, op)
    LAUNCHES[op] += 1
    return out


class PassPPlan(NamedTuple):
    """The pass-P grid (csrc/scf_mp.cu): ``n_parts`` edge shares times
    ``n_slices`` slices of ``width`` filter columns; each part's partial
    holds ``part_size`` floats, the packed ``[dW0 | db0 | dW1 | db1]``."""
    width: int
    n_slices: int
    part_size: int
    n_parts: int


def pass_p_plan(f, g, e, sms) -> PassPPlan:
    """Slices of 64 filter columns for F <= 256, 32 for F <= 512 and 16
    for F <= 1024 (a block keeps width x F floats of dW1 in registers);
    edge shares so that the grid is one block per SM, fewer when the
    partials would pass the budget or the edges are few."""
    width = 64 if f <= 256 else 32 if f <= 512 else 16
    n_slices = -(-f // width)
    part_size = g * f + f + f * f + f
    n_parts = min(max(1, sms // n_slices),
                  max(1, _PARTIAL_BUDGET // (4 * part_size)),
                  max(e, 1))
    return PassPPlan(width, n_slices, part_size, n_parts)


def launch_scf_pass_p(h, g, rbf, cm, w0, b0, w1, b1, senders, receivers,
                      row_ptr, want_geo):
    """One pass-P launch (plus its fixed-order reductions) over the
    receiver-order CSR ``row_ptr``.  Returns ``(dw0, db0, dw1, db1, drbf,
    dcm)``; drbf/dcm are None unless ``want_geo``, zero on masked
    edges."""
    from hydragnn_torch.kernels.build import load_library

    dev = h.device
    n, f = h.shape
    e, gd = rbf.shape
    _check_widths(f, gd)
    _require(h, "h", torch.float32, (n, f), dev)
    _require(g, "g", torch.float32, (n, f), dev)
    _require(rbf, "rbf", torch.float32, (e, gd), dev)
    _require(cm, "cm", torch.float32, (e,), dev)
    _require(senders, "senders", torch.int32, (e,), dev)
    _require(receivers, "receivers", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    w0, b0, w1, b1 = _weights(w0, b0, w1, b1, f, gd, dev)
    plan = pass_p_plan(
        f, gd, e, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((plan.n_parts, plan.part_size), dtype=torch.float32,
                          device=dev)
    wgrad = torch.empty((plan.part_size,), dtype=torch.float32, device=dev)
    drbf = dcm = drbf_part = dcm_part = None
    if want_geo:
        drbf = torch.zeros((e, gd), dtype=torch.float32, device=dev)
        dcm = torch.zeros((e,), dtype=torch.float32, device=dev)
        drbf_part, dcm_part = drbf, dcm
        if plan.n_slices > 1:
            drbf_part = torch.empty((plan.n_slices, e, gd),
                                    dtype=torch.float32, device=dev)
            dcm_part = torch.empty((plan.n_slices, e), dtype=torch.float32,
                                   device=dev)
    if n > 0 and f > 0:
        lib = load_library("scf_mp")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_scf_pass_p_f32(
                h.data_ptr(), g.data_ptr(), rbf.data_ptr(), cm.data_ptr(),
                senders.data_ptr(), receivers.data_ptr(), row_ptr.data_ptr(),
                w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                partial.data_ptr(), wgrad.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (drbf_part, dcm_part, drbf, dcm)),
                n, e, f, gd, plan.width, plan.n_parts, stream)
        _check_rc(rc, "scf_edge_pipeline_pass_p")
        LAUNCHES["scf_edge_pipeline_pass_p"] += 1
    else:
        wgrad.zero_()
    o1, o2, o3 = gd * f, gd * f + f, gd * f + f + f * f
    return (wgrad[:o1].view(gd, f), wgrad[o1:o2], wgrad[o2:o3].view(f, f),
            wgrad[o3:], drbf, dcm)


# ---------------------------------------------------------------------------
# the three passes: the kernel on a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def _forward(h, rbf, cm, em, w0, b0, w1, b1, senders, receivers):
    if not h.is_cuda:
        return scf_edge_pipeline_plain(h, rbf, cm, em, w0, b0, w1, b1,
                                       senders, receivers).float()
    row_ptr = segment_offsets(receivers, h.shape[0], em)
    return launch_scf_filter_gather(
        h.float().contiguous(), rbf.float().contiguous(),
        cm.float().contiguous(), w0, b0, w1, b1, senders, receivers, None,
        row_ptr, "scf_edge_pipeline")


def _pass_p(h, g, rbf, cm, em, w0, b0, w1, b1, senders, receivers,
            want_geo):
    if not h.is_cuda:
        return scf_pass_p_plain(h, g, rbf, cm, em, w0, b0, w1, b1, senders,
                                receivers)
    row_ptr = segment_offsets(receivers, h.shape[0], em)
    return launch_scf_pass_p(
        h.float().contiguous(), g, rbf.float().contiguous(),
        cm.float().contiguous(), w0, b0, w1, b1, senders, receivers,
        row_ptr, want_geo)


def _pass_s(g, rbf, cm, em, w0, b0, w1, b1, senders, receivers,
            sender_perm):
    if not g.is_cuda:
        # the forward with the roles swapped
        return scf_edge_pipeline_plain(g, rbf, cm, em, w0, b0, w1, b1,
                                       receivers, senders).float()
    if sender_perm is None:
        sender_perm = torch.argsort(senders, stable=True).to(torch.int32)
    p = sender_perm.long()
    row_ptr = segment_offsets(senders[p], g.shape[0], em[p])
    return launch_scf_filter_gather(
        g, rbf.float().contiguous(), cm.float().contiguous(), w0, b0, w1,
        b1, receivers, senders, sender_perm, row_ptr,
        "scf_edge_pipeline_pass_s")


class _ScfEdgePipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, rbf, cm, w0, b0, w1, b1, senders, receivers, em,
                sender_perm):
        ctx.save_for_backward(h, rbf, cm, w0, b0, w1, b1, senders,
                              receivers, em, sender_perm)
        return _forward(h, rbf, cm, em, w0, b0, w1, b1, senders,
                        receivers).to(h.dtype)

    @staticmethod
    def backward(ctx, gout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "scf_edge_pipeline is not differentiable twice: its "
                "backward runs hand-written kernels (pass P and pass S); "
                "the double backward of the energy-gradient force term "
                "comes with ROADMAP queue A3")
        (h, rbf, cm, w0, b0, w1, b1, senders, receivers, em,
         sender_perm) = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = gout.float().contiguous()
        grads = [None] * 11
        if any(need[1:7]):
            want_geo = need[1] or need[2]
            dw0, db0, dw1, db1, drbf, dcm = _pass_p(
                h, g, rbf, cm, em, w0, b0, w1, b1, senders, receivers,
                want_geo)
            for i, d, like in ((1, drbf, rbf), (2, dcm, cm), (3, dw0, w0),
                               (4, db0, b0), (5, dw1, w1), (6, db1, b1)):
                if need[i]:
                    grads[i] = d.to(like.dtype)
        if need[0]:
            grads[0] = _pass_s(g, rbf, cm, em, w0, b0, w1, b1, senders,
                               receivers, sender_perm).to(h.dtype)
        return tuple(grads)


def scf_edge_pipeline(h, rbf, cm, em, w0, b0, w1, b1, senders, receivers,
                      sender_perm):
    """``out[n] = sum_{e: recv[e]=n} h[send[e]] * filt_e`` with
    ``filt_e = (ssp(rbf_e @ w0 + b0) @ w1 + b1) * cm_e`` — the reference's
    signature and contract (hydragnn_tpu/ops/scf_mp.py).

    Differentiable once wrt h, rbf, cm, w0, b0, w1 and b1 (a double
    backward raises).  Requires
    nondecreasing ``receivers``, ``sender_perm`` the stable argsort of
    ``senders`` (None computes it), G <= 127 and F <= 1024.  ``em`` is the
    int edge-validity mask: em == 0 edges carry cm == 0, sort last in both
    orderings, and get exactly zero for every grad — callers must not
    consume dcm on masked edges."""
    return _ScfEdgePipeline.apply(h, rbf, cm, w0, b0, w1, b1, senders,
                                  receivers, em, sender_perm)
