"""Real lanes over padded lanes of the waves that answered requests in the
window, in %."""


def read(run):
    waves = {r["wave_id"]: (r["wave_real"], r["wave_padded"]) for r in run.requests}
    padded = sum(p for _, p in waves.values())
    return 100.0 * sum(r for r, _ in waves.values()) / padded if padded else None
