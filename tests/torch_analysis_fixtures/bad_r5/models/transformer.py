def decode_step(cfg, params, cache, token):
    """Writes cache["k"] and cache["v"] in place."""
    cache["k"][0] = token
    return token, cache
