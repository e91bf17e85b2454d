"""Kinds of BLADE-FL job: what the harness needs to know of one, found by
the ``job`` a traffic file names (``jobs/<job>.py``). A job module gives

  JUDGED               the ``RoundSpec`` fields its reference follows; a
                       traffic file's ``spec`` may set no other (the rest
                       keep the port's defaults)
  MIX_MODE             the mix the program must dispatch
                       (``rounds.LAST_DISPATCH["mix_mode"]``)
  evaluates(spec, k, n_rounds)
                       whether round k computes the global loss
  launches(spec, family, widths, n_rounds, n_leaves)
                       each kernel's launches in a job on the card
  reference_job(weights, widths, tokens, spec, loss)
                       the plain job (``fl_bench/reference``)
"""
import importlib


def load(name: str):
    return importlib.import_module(f"fl_bench.jobs.{name}")
