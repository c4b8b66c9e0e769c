"""One driver per kind of traffic, `<driver>.py` with a `Cell(cfg, params,
seed, device, spans, substitute)` whose construction is the set-up and
warm-up, and `window(seconds)`, `notes()`, `release()` and
`compare(limits)`."""
