"""The card lockstep's ReLU ties (``chip_smoke.lockstep_step``), on the CPU.

A tiny model, Linear(2, 3) -> ReLU -> Linear(3, 1), on one input whose
second entry (3e-8) is lost to float32 in unit A's sum: the CPU's float32
run is 3e-8 from the float64 run there, so the margin of that input's row
is ``TIE_MARGIN_SLACK`` times that (a row of larger entries beside it
does not widen it).  Unit B's input is set near zero; a
"card" model whose unit-B bias differs puts that input on the other side,
as a card that sums in another order may.  Within the margin the float64
yardstick must take the card's branch for the card's gradients (and the
CPU's for the CPU's), and the grading must pass with the allowance the
CPU alone sets; the same disagreement beyond the margin must be refused.
"""

import pytest
import torch

import chip_smoke

X = torch.tensor([[1.0, 3e-8]], dtype=torch.float32)


class _Tiny(torch.nn.Module):
    def __init__(self, bias_b):
        super().__init__()
        self.lin1 = torch.nn.Linear(2, 3)
        self.act = torch.nn.ReLU()
        self.lin2 = torch.nn.Linear(3, 1)
        with torch.no_grad():
            # unit A: 1 + 3e-8 (float32 drops the 3e-8); unit B: 3e-8 +
            # bias_b; unit C: 1.5
            self.lin1.weight.copy_(torch.tensor([[1.0, 1.0], [0.0, 1.0],
                                                 [1.0, 0.0]]))
            self.lin1.bias.copy_(torch.tensor([0.0, bias_b, 0.5]))
            self.lin2.weight.copy_(torch.tensor([[0.7, -1.3, 0.4]]))
            self.lin2.bias.copy_(torch.tensor([0.2]))

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _run(model, x):
    loss = model(x).sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), [d.detach() for d in grads], []


def _step(bias_cpu, bias_card, x=X):
    cpu, card = _Tiny(bias_cpu), _Tiny(bias_card)
    ref = _Tiny(bias_cpu).double()
    names = [k for k, _ in cpu.named_parameters()]
    out = chip_smoke.lockstep_step(torch, _run, _run, cpu, card, ref, x, x,
                                   x.double())
    (_, gc, _), (_, gg, _), gr_cpu, gr_card, notes = out
    return names, gc, gg, gr_cpu, gr_card, notes


def _counts(notes):
    return {k: notes[k]
            for k in ("ties_cpu", "ties_card", "second_float64_run")}


def _graded(names, gc, gg, gr_cpu, gr_card):
    return chip_smoke.grade_leaves(
        "tiny in lockstep",
        chip_smoke.step_leaves(0, names, gc, gg, gr_cpu, gr_card))


def test_margin_is_the_cpus_float32_error():
    margins = [[]]
    cpu = _Tiny(-2e-8)
    tape, handles = chip_smoke.record_relus(torch, cpu, keep=True)
    cpu(X)
    for h in handles:
        h.remove()
    ref = _Tiny(-2e-8).double()
    notes, handles = chip_smoke.relu_yardstick(torch, ref, tape, margins,
                                               tape["inputs"])
    ref(X.double())
    for h in handles:
        h.remove()
    err = float((tape["inputs"][0][0].double()
                 - ref.lin1(X.double()).detach()).abs().max())
    assert 2e-8 < err < 4e-8
    assert len(margins[0]) == 1 and margins[0][0].shape == (1, 1)
    assert float(margins[0][0]) == chip_smoke.TIE_MARGIN_SLACK * err
    assert notes == {"ties": 0, "tie_abs_max": None, "tie_margin": None,
                     "outside": 0}


def test_a_tie_within_the_margin_is_decided_the_cards_way():
    # unit B: 1e-8 on the CPU (and in float64), -1e-8 on the card
    names, gc, gg, gr_cpu, gr_card, notes = _step(-2e-8, -4e-8)
    assert _counts(notes) == {"ties_cpu": 0, "ties_card": 1,
                              "second_float64_run": True}
    assert len(notes["float64_runs_s"]) == 2
    # the decided tie lay 1e-8 from zero, inside its call's margin
    assert notes["tie_abs_max_cpu"] is None
    assert notes["tie_abs_max_card"] == pytest.approx(1e-8, rel=1e-3)
    assert notes["tie_abs_max_card"] <= notes["tie_margin_card"]
    b = names.index("lin1.bias")
    assert float(gr_cpu[b][1]) != 0.0 and float(gr_card[b][1]) == 0.0
    got = _graded(names, gc, gg, gr_cpu, gr_card)
    assert got["card_vs_float64_over_own_largest"] < 1e-6
    # the allowance is the one the CPU alone sets
    same = _graded(*_step(-2e-8, -2e-8)[:5])
    assert got["card_vs_float64_allowed"] == same["card_vs_float64_allowed"]
    # graded against the CPU's yardstick, the card's tie is refused
    with pytest.raises(RuntimeError, match="from the float64 gradient"):
        _graded(names, gc, gg, gr_cpu, gr_cpu)


def test_the_same_disagreement_beyond_the_margin_is_refused():
    # unit B: 1e-6 on the CPU and in float64, -1e-6 on the card
    with pytest.raises(RuntimeError, match="beyond float32's margin"):
        _step(9.7e-7, -1.03e-6)


def test_a_large_row_does_not_widen_a_small_rows_margin():
    # a second row at 3e4, where float32 drops ~2e-3 of unit A's sum: the
    # call's largest error, 5x of which would cover unit B's 1e-6 in row 0
    x = torch.tensor([[1.0, 3e-8], [3e4, 3e-3]], dtype=torch.float32)
    margins = [[]]
    cpu = _Tiny(9.7e-7)
    tape, handles = chip_smoke.record_relus(torch, cpu, keep=True)
    cpu(x)
    for h in handles:
        h.remove()
    ref = _Tiny(9.7e-7).double()
    _, handles = chip_smoke.relu_yardstick(torch, ref, tape, margins,
                                           tape["inputs"])
    ref(x.double())
    for h in handles:
        h.remove()
    row0, row1 = (float(m) for m in margins[0][0][:, 0])
    assert row0 < 2e-7 and row1 > 1e-3
    # the card puts row 0's unit B at -1e-6 (row 1's stays positive)
    with pytest.raises(RuntimeError, match="beyond float32's margin"):
        _step(9.7e-7, -1.03e-6, x)


def test_agreeing_runs_take_one_float64_run():
    names, gc, gg, gr_cpu, gr_card, notes = _step(-2e-8, -2e-8)
    assert _counts(notes) == {"ties_cpu": 0, "ties_card": 0,
                              "second_float64_run": False}
    assert len(notes["float64_runs_s"]) == 1
    assert gr_card is gr_cpu
