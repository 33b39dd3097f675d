"""Host milliseconds of ``ServingEngine`` prefill (``stats["prefill_s"]``,
a synchronize to a synchronize) per thousand prompt tokens, over the
untraced calls of a traced window."""


def read(ctx):
    rest = ctx.window.rest
    if ctx.mix["kind"] != "serve":
        return None
    s = sum(r["stats"]["prefill_s"] for r in rest)
    n = sum(r["stats"]["prefill_tokens"] for r in rest)
    return s * 1e3 / (n / 1e3) if n else None
