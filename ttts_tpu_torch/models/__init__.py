"""PyTorch model definitions of the serving path (codec extract, GPT,
diffusion net, Vocos)."""
