"""Prompt tokens the prefix cache served to the window's aLoRA
evaluation requests, as a share of their prompt tokens (the engine's
``Request.n_cache_hit_tokens``, set at admission)."""


def read(rec):
    ev = [t for t in rec.window_requests if t.kind == "eval"
          and t.t_done is not None]
    total = sum(t.prompt_len for t in ev)
    if not total:
        return None
    return 100.0 * sum(t.req.n_cache_hit_tokens for t in ev) / total
