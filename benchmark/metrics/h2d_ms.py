"""Device time a call of the host-to-device copies (the ingest of the
batch), by name from the traced window's device timeline."""


def read(run):
    tl = run.get("timeline")
    if tl is None:
        return None
    ms = sum(e - s for name, s, e in tl.device if "HtoD" in name) / 1e3
    return ms / run["traced_calls"] if ms > 0 else None
