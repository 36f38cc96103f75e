"""The control: the reference in the precision below the configuration's
(fp8 in place of bf16, ``reference.py``), put in the program's place, must
come out not correct against the cell's limits: on the card (``cuda``), at
the cell's own size, as the limits were read. On the CPU, at a small size
where those limits do not apply, it reads above the program."""

import pytest
import torch

import compare
import drive_serve
import drive_train

TRAIN = ["granite-moe-1b-a400m.train-8x4k", "hymba-1.5b.train-2x8k"]
SERVE = ["hymba-1.5b.serve-32k"]


def control_numbers(cell, dev, seed):
    if cell["mix"]["kind"] == "train":
        t = drive_train.Train(cell, dev)
        return compare.train_numbers(t.reference(seed, "fp8"), t.reference(seed))
    s = drive_serve.Serve(cell, dev)
    eng = s.engine(seed)
    served = [(p := s.prompt(seed, i), s.serve(eng, p)[0])
              for i in range(cell["mix"]["checked_requests"])]
    del eng
    return {"logit_gap": max(s.gaps(seed, served, control=True))}


def program_numbers(cell, dev, seed):
    if cell["mix"]["kind"] == "train":
        t = drive_train.Train(cell, dev)
        _, _, prog = t.first_steps(seed)
        return compare.train_numbers(prog, t.reference(seed))
    s = drive_serve.Serve(cell, dev)
    eng = s.engine(seed)
    served = [(p := s.prompt(seed, i), s.serve(eng, p)[0])
              for i in range(cell["mix"]["checked_requests"])]
    return {"logit_gap": max(s.gaps(seed, served))}


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_reads_above_the_program_small(small_cell, name):
    """At the CPU's size the limits (set at the cell's) do not apply, but
    the control still reads above the bf16 program on some number."""
    cell = small_cell(name, "bfloat16", wide=name in SERVE)
    cpu, seed = torch.device("cpu"), 2**31 + 23
    ctl, prog = control_numbers(cell, cpu, seed), program_numbers(cell, cpu, seed)
    assert any(ctl[k] > prog[k] for k in cell["limits"]), (ctl, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_is_not_correct_on_the_card(card, name):
    import harness

    cell = harness.cell(harness.load_benchmark(), name)
    numbers = control_numbers(cell, card, 2**31 + 29)
    ok, checks = compare.judge(numbers, cell["limits"])
    assert not ok, checks
