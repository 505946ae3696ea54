"""Engine and scheduler: live decode rows per decode step over the window
(the engine's ``n_decode_steps`` counter, rows read off the tokens)."""


def read(run):
    steps = run.counter("n_decode_steps")
    rows = sum(len(s.decode_ctx) for s in run.window_steps())
    return rows / steps if steps else None
