"""The LM substrate's models: ``config.py`` (the JAX package's model and
shape configurations, copied), ``layers.py`` and ``model.py`` (the dense
decoder family on tensors) and ``convert.py`` (the reference's parameter
pytrees to the port's module state and back)."""
