"""Host milliseconds per answered request of the server's copies: the
waves' images and velocities to the card (``serve.h2d``) and their
velocities and mismatches back (``serve.d2h``)."""

from regbench import spans as S


def read(run):
    spans = S.recorded()
    if spans is None or not run.requests:
        return None
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans
          if s.name in ("serve.h2d", "serve.d2h")]
    return sum(ms) / len(run.requests) if ms else None
