"""The program's own spans (raisimlib_torch.utils.profiling's records), for
the readers of `program_span` metrics that open inside the program. A
program that records no spans gives none, and those readers then find
nothing to read."""


def records() -> list:
  """The spans the program recorded: (name, start_ns, end_ns, parent,
  attrs) each, in the order they opened; [] where it records none."""
  from raisimlib_torch.utils import profiling

  get = getattr(profiling, "records", None)
  return get() if get is not None else []


def duration_ns(r) -> int:
  return r.end_ns - r.start_ns
