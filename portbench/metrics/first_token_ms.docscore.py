"""Mean milliseconds from the end of a request's prefill (its admission
where it had none) to its first token emitted: the engine's first_token_s
over first_tokens, for the first tokens of the window."""


def read(run):
    n = run.delta('first_tokens')
    return run.delta('first_token_s') * 1e3 / n if n else None
