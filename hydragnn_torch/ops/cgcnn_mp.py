"""CGCNN's fused gated sum (port of hydragnn_tpu/ops/cgcnn_mp.py with the
``cgcnn`` spec of hydragnn_tpu/ops/fused_block.py).

  z_e    = [x[recv_e], x[send_e], edge_attr_e]
  out[n] = sum_{e: recv[e]=n} sigmoid(z_e @ kf + bf) * softplus(z_e @ ks + bs)

``kf``, ``ks [2F+A, D]`` are the composed path's concat kernels, split here
by row ranges into the receiver, sender and edge-attribute blocks; the
biases stay vectors (Hopper needs no 128-lane packing and no bias lane).
The output width ``D`` may differ from ``F``; ``edge_attr=None`` is an
edge-attribute payload of width zero.

Three kernels, hand-written in CUDA C++ for Hopper (csrc/cgcnn_mp.cu,
built by kernels/build.py), none of which writes an ``[E, D]`` or
``[E, 2F+A]`` tensor to device memory.  The receiver is the primary side:

- forward (the reference's ``_fused_fwd``): the node table ``T = x @ [Wfr
  | Wsr | Wfs | Wss]`` ``[N, 4D]`` (3xTF32 on the tensor cores, pass P's
  table kernel), then one warp per receiver row: ``tf = T[r, :D] + bf +
  T[s, 2D:3D]`` (+ ``edge_attr @ Wfg``), ``ts`` likewise from the next
  blocks, ``sigmoid(tf) * softplus(ts)`` summed into the row in edge
  order.  Two CUDA launches, counted as one in ``LAUNCHES["cgcnn_block"]``
  (one per forward);
- pass P (``_bwd_p_kernel``): receiver order, the node table once per
  launch, then per edge only ``(dtf, dts)``
  and the sender-side weight gradients, per receiver row (once) the
  receiver-side ones and ``dx`` of the receiver side, and the per-edge
  ``d edge_attr``; products on the tensor cores in 3xTF32, the grid split
  into runs of whole receiver rows and slices of the output columns
  (:func:`pass_p_plan`), each part's partial in ``wgrad``'s packed
  layout, the parts reduced in a fixed order;
- pass S (``_bwd_s_kernel``): sender order through ``sender_perm``; one
  warp per sender row gathers the receivers' half-rows of pass P's node
  table (the backward hands it over) and ``dout[r]``, forms ``(dtf,
  dts)`` and sums them into the row in position order (``[N, 2D]``), then
  ``dx = [sum dtf | sum dts] @ [Wfs | Wss]^T``, one row product per
  sender, in 3xTF32 on the tensor cores: two CUDA launches, counted as one
  in ``LAUNCHES["cgcnn_block_pass_s"]``.

The backward written out (see :func:`cgcnn_pass_p_plain`,
:func:`cgcnn_pass_s_plain`), with ``g = dout[recv_e]``:

  dtf = g * softplus(ts) * sigmoid(tf) * (1 - sigmoid(tf))
  dts = g * sigmoid(tf) * softplus'(ts)
  dkf = z^T dtf, dbf = sum dtf;  dks = z^T dts, dbs = sum dts
  dz  = dtf @ kf^T + dts @ ks^T = [dx_r | dx_s | d edge_attr]

``softplus`` is ``torch.nn.functional.softplus`` (threshold 20) on both
sides.  Masked edges (``em == 0``) sort last in both edge orderings
(collate guarantees it); they are never visited and get exactly zero for
every output and every gradient.

Each leaf takes a CPU tensor to its plain PyTorch version (the CPU path and
the tests' oracle) and a CUDA tensor to its kernel; a CUDA input the
kernel does not take raises.  ``LAUNCHES`` counts one per launch of each
op (the forward's and pass S's two CUDA launches count one).
:func:`cgcnn_block_reference` is the composed version under autograd: the
reference the kernels are held to.  The op is differentiable once: a
double backward raises (the force term, ROADMAP queue A3).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_torch.ops.egcl_mp import _ptr, _valid_edges, split_weights
from hydragnn_torch.ops.fused_mp import _check_rc, _require

# the reference's structural limits (ops/cgcnn_mp.py): F <= 256 and at
# most 127 edge-attribute lanes; the output width shares F's limit here
CGCNN_F_LIMIT = 256
CGCNN_GEO_LIMIT = 127

LAUNCHES: Dict[str, int] = {
    "cgcnn_block": 0,
    "cgcnn_block_pass_p": 0,
    "cgcnn_block_pass_s": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _pre(x, edge_attr, kf, bf, ks, bs, send, recv):
    parts = [x[recv], x[send]]
    if edge_attr is not None:
        parts.append(edge_attr)
    z = torch.cat(parts, dim=-1)
    return z, z @ kf + bf, z @ ks + bs


def cgcnn_block_reference(x, edge_attr, em, kf, bf, ks, bs, senders,
                          receivers):
    """The composed gated sum on raw weights: gathers, concat, the two
    dense layers, sigmoid * softplus, ``index_add_`` at the receivers.
    Differentiable under autograd in every float input; masked edges give
    exactly zero for every output and every gradient.  The forward
    kernel's plain version."""
    n = x.shape[0]
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    _, tf, ts = _pre(x, edge_attr, kf, bf, ks, bs, send, recv)
    msg = torch.sigmoid(tf) * F.softplus(ts)
    msg = torch.where(ok[:, None], msg,
                      torch.zeros((), dtype=msg.dtype, device=x.device))
    return torch.zeros((n, msg.shape[1]), dtype=msg.dtype,
                       device=x.device).index_add(0, recv, msg)


def _backward_plain(x, edge_attr, em, kf, bf, ks, bs, senders, receivers,
                    gout):
    """The chain recomputed and taken back to ``(dtf, dts)``, zero on
    masked edges, with the gathered inputs both passes need."""
    n = x.shape[0]
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    z, tf, ts = _pre(x, edge_attr, kf, bf, ks, bs, send, recv)
    zero = torch.zeros((), dtype=tf.dtype, device=x.device)
    g = torch.where(ok[:, None], gout[recv], zero)
    sf = torch.sigmoid(tf)
    # softplus'(v) as PyTorch's softplus backward: 1 above the threshold
    sgs = torch.where(ts > 20.0, torch.ones_like(ts), torch.sigmoid(ts))
    dtf = g * F.softplus(ts) * (sf * (1.0 - sf))
    dts = g * sf * sgs
    return dict(ok=ok, send=send, recv=recv, z=z, dtf=dtf, dts=dts,
                zero=zero)


def cgcnn_pass_p_plain(x, edge_attr, em, kf, bf, ks, bs, senders, receivers,
                       gout):
    """Pass P written out: ``(dkf, dbf, dks, dbs, d edge_attr or None,
    dx_receiver)``, zero on masked edges."""
    r = _backward_plain(x, edge_attr, em, kf, bf, ks, bs, senders,
                        receivers, gout)
    n, f = x.shape
    z, dtf, dts = r["z"], r["dtf"], r["dts"]
    kfr, _, kfg = split_weights(kf, f)
    ksr, _, ksg = split_weights(ks, f)
    dea = None
    if edge_attr is not None:
        dea = torch.where(r["ok"][:, None], dtf @ kfg.t() + dts @ ksg.t(),
                          r["zero"])
    dx_r = torch.zeros((n, f), dtype=dtf.dtype, device=x.device).index_add(
        0, r["recv"], dtf @ kfr.t() + dts @ ksr.t())
    return (z.t() @ dtf, dtf.sum(0), z.t() @ dts, dts.sum(0), dea, dx_r)


def cgcnn_pass_s_plain(x, edge_attr, em, kf, bf, ks, bs, senders, receivers,
                       gout):
    """Pass S written out: ``dx_sender [N, F]``."""
    r = _backward_plain(x, edge_attr, em, kf, bf, ks, bs, senders,
                        receivers, gout)
    n, f = x.shape
    _, kfs, _ = split_weights(kf, f)
    _, kss, _ = split_weights(ks, f)
    return torch.zeros((n, f), dtype=r["dtf"].dtype, device=x.device
                       ).index_add(0, r["send"],
                                   r["dtf"] @ kfs.t() + r["dts"] @ kss.t())


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def check_widths(f, d, a):
    if not (1 <= f <= CGCNN_F_LIMIT and 1 <= d <= CGCNN_F_LIMIT
            and 0 <= a <= CGCNN_GEO_LIMIT):
        raise ValueError(
            f"the cgcnn kernels take F <= {CGCNN_F_LIMIT}, D <= "
            f"{CGCNN_F_LIMIT} and A <= {CGCNN_GEO_LIMIT}, got F={f}, D={d}, "
            f"A={a}")


def kernel_weights(kf, bf, ks, bs, f, a, dev):
    """The eight contiguous float32 blocks the kernels take: ``(wfr, wfs,
    wfg, bf, wsr, wss, wsg, bs)`` (``wfg``, ``wsg`` None when A = 0).
    ``kf``, ``ks`` may be views (the model passes ``Linear.weight.t()``)."""
    d = kf.shape[1]
    out, names, shapes = [], [], []
    for k, b, tag in ((kf, bf, "f"), (ks, bs, "s")):
        if tuple(k.shape) != (2 * f + a, d):
            raise ValueError(f"k{tag} has shape {tuple(k.shape)}, expected "
                             f"{(2 * f + a, d)}")
        r, s, g = (t.contiguous() for t in split_weights(k, f))
        out += [r, s, g if a else None, b.contiguous()]
        names += [f"k{tag} (receiver rows)", f"k{tag} (sender rows)",
                  f"k{tag} (edge_attr rows)", f"b{tag}"]
        shapes += [(f, d), (f, d), (a, d), (d,)]
    for t, name, shape in zip(out, names, shapes):
        if t is not None:
            _require(t, name, torch.float32, shape, dev)
    return tuple(out)


class PassPPlan(NamedTuple):
    """The pass-P grid: ``n_parts`` runs of receiver rows times
    ``n_slices`` slices of ``wp`` output columns; each part's partial
    holds ``part_size`` floats, the layout of ``wgrad``."""
    wp: int
    n_slices: int
    part_size: int
    n_parts: int


def pass_p_plan(f, d, a, e, sms, wp) -> PassPPlan:
    """The grid for slices of ``wp`` output columns (the kernel's choice,
    ``hg_cgcnn_pass_p_width``): one block per SM, fewer parts when the
    edges are few."""
    n_slices = -(-d // wp)
    n_parts = max(1, min(sms // n_slices, max(e, 1)))
    return PassPPlan(wp, n_slices, 2 * (2 * f + a + 1) * d, n_parts)


def launch_cgcnn(op, x, edge_attr, weights, senders, receivers, perm,
                 row_ptr, gout=None, want_dx=True, want_ea=False, table=None):
    """One launch of the cgcnn kernel ``op`` names, on a precomputed CSR
    schedule ``row_ptr`` over positions (receiver order, ``perm`` None, for
    the forward and pass P; sender order through ``perm`` for pass S).
    ``table [N, 4D]``: pass P writes the node table into it when given;
    pass S reads it there and needs it.  Returns:

    - ``cgcnn_block``: ``out [N, D]``;
    - ``cgcnn_block_pass_p``: ``(wgrad, d edge_attr or None, dx_receiver
      or None)``, ``wgrad`` the flat reduced weight gradients (see
      :func:`unpack_wgrad`);
    - ``cgcnn_block_pass_s``: ``dx_sender``.
    """
    from hydragnn_torch.kernels.build import load_library

    dev = x.device
    n, f = x.shape
    e = senders.shape[0]
    d = weights[0].shape[1]
    a = 0 if edge_attr is None else edge_attr.shape[1]
    check_widths(f, d, a)
    _require(x, "x", torch.float32, (n, f), dev)
    if edge_attr is not None:
        _require(edge_attr, "edge_attr", torch.float32, (e, a), dev)
    _require(senders, "senders", torch.int32, (e,), dev)
    _require(receivers, "receivers", torch.int32, (e,), dev)
    if perm is not None:
        _require(perm, "sender_perm", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    if e >= 2**31 or n >= 2**31:
        raise ValueError("the kernel indexes edges and rows with int32")
    if op != "cgcnn_block":
        _require(gout, "dout", torch.float32, (n, d), dev)
    if table is not None:
        _require(table, "table", torch.float32, (n, 4 * d), dev)
    lib = load_library("cgcnn_mp")
    if op == "cgcnn_block_pass_p":
        return _launch_pass_p(lib, x, edge_attr, weights, senders,
                              receivers, row_ptr, gout, want_dx, want_ea,
                              table)
    fwd = op == "cgcnn_block"
    if fwd and perm is not None:
        raise ValueError("cgcnn_block runs in receiver order: no permutation")
    if not fwd and perm is None:
        raise ValueError("cgcnn_block_pass_s needs the sender permutation")
    if not fwd and table is None:
        raise ValueError("cgcnn_block_pass_s reads pass P's node table: "
                         "pass table")
    out = torch.empty((n, d if fwd else f), dtype=torch.float32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if fwd:
                # the node table: scratch, the second launch's input
                table = torch.empty((n, 4 * d), dtype=torch.float32,
                                    device=dev)
                rc = lib.hg_cgcnn_fwd_f32(
                    x.data_ptr(), _ptr(edge_attr), senders.data_ptr(),
                    row_ptr.data_ptr(), *(_ptr(w) for w in weights),
                    table.data_ptr(), out.data_ptr(), n, f, d, a, stream)
            else:
                # the per-sender [sum dtf | sum dts]: scratch
                sums = torch.empty((n, 2 * d), dtype=torch.float32,
                                   device=dev)
                _, wfs, wfg, bf, _, wss, wsg, bs = weights
                rc = lib.hg_cgcnn_pass_s_f32(
                    _ptr(edge_attr), receivers.data_ptr(), perm.data_ptr(),
                    row_ptr.data_ptr(),
                    *(_ptr(w) for w in (wfs, wfg, bf, wss, wsg, bs)),
                    gout.data_ptr(), table.data_ptr(), sums.data_ptr(),
                    out.data_ptr(), n, f, d, a, stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    return out


def _launch_pass_p(lib, x, edge_attr, weights, senders, receivers, row_ptr,
                   gout, want_dx, want_ea, table):
    dev = x.device
    n, f = x.shape
    e = senders.shape[0]
    d = weights[0].shape[1]
    a = 0 if edge_attr is None else edge_attr.shape[1]
    with torch.cuda.device(dev):
        wp = lib.hg_cgcnn_pass_p_width(f, d, a)
    if wp < 0:
        raise RuntimeError(
            f"cgcnn_block_pass_p: no slice of F={f}, D={d}, A={a} fits the "
            f"device's shared memory")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = pass_p_plan(f, d, a, e, sms, wp)
    wgrad = torch.empty((plan.part_size,), dtype=torch.float32, device=dev)
    dx = dea = dx_part = dea_part = None
    if want_dx:
        dx = dx_part = torch.empty((n, f), dtype=torch.float32, device=dev)
        if plan.n_slices > 1:
            dx_part = torch.empty((plan.n_slices, n, f), dtype=torch.float32,
                                  device=dev)
    if want_ea and a:
        dea = dea_part = torch.zeros((e, a), dtype=torch.float32, device=dev)
        if plan.n_slices > 1:
            dea_part = torch.empty((plan.n_slices, e, a), dtype=torch.float32,
                                   device=dev)
    if n == 0:
        return wgrad.zero_(), dea, dx
    if table is None:
        table = torch.empty((n, 4 * d), dtype=torch.float32, device=dev)
    partial = torch.empty((plan.n_parts, plan.part_size), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hg_cgcnn_pass_p_f32(
            x.data_ptr(), _ptr(edge_attr), senders.data_ptr(),
            receivers.data_ptr(), row_ptr.data_ptr(),
            *(_ptr(w) for w in weights), gout.data_ptr(), table.data_ptr(),
            partial.data_ptr(), wgrad.data_ptr(),
            *(_ptr(t) for t in (dx_part, dea_part, dx, dea)), n, e, f, d, a,
            plan.wp, plan.n_parts, stream)
    _check_rc(rc, "cgcnn_block_pass_p")
    LAUNCHES["cgcnn_block_pass_p"] += 1
    return wgrad, dea, dx


def unpack_wgrad(wgrad, f, d, a):
    """Pass P's flat ``wgrad`` -> ``(dkf [2F+A, D], dbf, dks, dbs)``;
    views of ``wgrad``."""
    rows = 2 * f + a
    blocks = wgrad[:2 * (rows + 1) * d].view(-1, d).split(
        [rows, 1, rows, 1])
    return blocks[0], blocks[1][0], blocks[2], blocks[3][0]


# ---------------------------------------------------------------------------
# the three passes: the kernel on a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

class _CgcnnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edge_attr, kf, bf, ks, bs, senders, receivers, em,
                sender_perm):
        ctx.save_for_backward(x, edge_attr, kf, bf, ks, bs, senders,
                              receivers, em, sender_perm)
        if not x.is_cuda:
            return cgcnn_block_reference(x, edge_attr, em, kf, bf, ks, bs,
                                         senders, receivers)
        n, f = x.shape
        a = 0 if edge_attr is None else edge_attr.shape[1]
        ws = kernel_weights(kf, bf, ks, bs, f, a, x.device)
        return launch_cgcnn(
            "cgcnn_block", x.contiguous(),
            None if edge_attr is None else edge_attr.contiguous(), ws,
            senders, receivers, None, segment_offsets(receivers, n, em))

    @staticmethod
    def backward(ctx, gout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "cgcnn_gated_block is not differentiable twice: its "
                "backward runs hand-written kernels (pass P and pass S); "
                "the double backward of the energy-gradient force term "
                "comes with ROADMAP queue A3")
        (x, edge_attr, kf, bf, ks, bs, senders, receivers, em,
         sender_perm) = ctx.saved_tensors
        need = ctx.needs_input_grad
        n, f = x.shape
        a = 0 if edge_attr is None else edge_attr.shape[1]
        gout = gout.contiguous()
        grads = [None] * 10
        want_dx = need[0]
        want_ea = edge_attr is not None and need[1]
        if not x.is_cuda:
            args = (x, edge_attr, em, kf, bf, ks, bs, senders, receivers,
                    gout)
            dkf, dbf, dks, dbs, dea, dx = cgcnn_pass_p_plain(*args)
            if want_dx:
                dx = dx + cgcnn_pass_s_plain(*args)
        else:
            ws = kernel_weights(kf, bf, ks, bs, f, a, x.device)
            xc = x.contiguous()
            ec = None if edge_attr is None else edge_attr.contiguous()
            # the node table: pass P writes it, pass S reads it
            table = torch.empty((n, 4 * kf.shape[1]), dtype=torch.float32,
                                device=x.device)
            wgrad, dea, dx_r = launch_cgcnn(
                "cgcnn_block_pass_p", xc, ec, ws, senders, receivers, None,
                segment_offsets(receivers, n, em), gout, want_dx=want_dx,
                want_ea=want_ea, table=table)
            dkf, dbf, dks, dbs = unpack_wgrad(wgrad, f, kf.shape[1], a)
            dx = None
            if want_dx:
                p = sender_perm.long()
                dx_s = launch_cgcnn(
                    "cgcnn_block_pass_s", xc, ec, ws, senders, receivers,
                    sender_perm, segment_offsets(senders[p], n, em[p]), gout,
                    table=table)
                dx = dx_r + dx_s
        for i, dt, like in ((0, dx, x), (1, dea, edge_attr), (2, dkf, kf),
                            (3, dbf, bf), (4, dks, ks), (5, dbs, bs)):
            if need[i]:
                grads[i] = dt.reshape(like.shape).to(like.dtype)
        return tuple(grads)


def cgcnn_gated_block(x, edge_attr, em, kf, bf, ks, bs, senders, receivers,
                      sender_perm):
    """Fused CGCNN gated sum — the reference's signature and contract
    (hydragnn_tpu/ops/cgcnn_mp.py:cgcnn_gated_block).

    ``out[n] = sum_{e: recv[e]=n} sigmoid(z_e @ kf + bf) * softplus(z_e @
    ks + bs)`` with ``z_e = [x[recv_e], x[send_e], edge_attr_e]``.
    Weights are ``[in, out]`` (pass ``Linear.weight.t()``); ``edge_attr``
    may be None.  Differentiable once wrt x, edge_attr, kf, bf, ks and bs.
    Requires nondecreasing ``receivers``, ``sender_perm`` the stable
    argsort of ``senders``, masked edges (``em == 0``) last in both
    orderings, and the cgcnn width limits (callers gate)."""
    return _CgcnnBlock.apply(x, edge_attr, kf, bf, ks, bs, senders,
                             receivers, em, sender_perm)
