"""Fault hooks of traffic `tracer_group` (test_faults.py,
test_tracer_group_faults.py): K3, launched once per tracer, whose output
is that tracer's flux, and the group step around it (`each_tracer`, which
the family's loop runs)."""

import dataclasses

import torch

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.cke.rows", "cke_rows")
ANSWER = STEP
# (module, attribute) of the group step
GROUP = ("cdk_torch.kernels.cke.problem", "each_tracer")


def unchanged(cells, c1, c3, t, ntf, adv_mask, coef3, out=None):
    """STEP's stand-in (test_faults.py's test_state_unchanged_is_caught):
    the edge field ntf handed back as the flux."""
    return ntf.clone()


def no_third_order(real):
    """STEP's stand-in: the flux without its third-order term."""

    def step(cells, c1, c3, t, ntf, adv_mask, coef3, out=None):
        return real(cells, c1, c3, t, ntf, adv_mask, 0.0, out)

    return step


def first_for_all(real):
    """GROUP's stand-in: tracer 0's flux returned for every tracer."""

    def group(step2, aux, data):
        if data.tracer.dim() == 2:
            return real(step2, aux, data)
        first = real(step2, aux,
                     dataclasses.replace(data, tracer=data.tracer[:1]))
        return first.expand(data.tracer.shape[0], *first.shape[1:]).clone()

    return group


def writes_state(real):
    """GROUP's stand-in: writes into the seeded tracer group, where the cell
    mask is 0 (so the flux stays right), then steps."""

    def group(step2, aux, data):
        with torch.no_grad():
            data.tracer.masked_fill_(data.cell_mask == 0, 1.0)
        return real(step2, aux, data)

    return group


# the faults test_tracer_group_faults.py plants: name -> (where, stand-in
# made from the real attribute)
FAULTS = {"first_for_all": (GROUP, first_for_all),
          "no_third_order": (STEP, no_third_order),
          "writes_state": (GROUP, writes_state)}
