"""The LM substrate: config, norms and RoPE, attention, MLP, decoder."""
