"""The LM substrate's models: ``config.py`` (the JAX package's model and
shape configurations, copied), ``layers.py``, ``ssm.py`` and ``model.py``
(the decoder, RWKV6 and Mamba2 families on tensors) and ``convert.py``
(the reference's parameter pytrees to the port's module state and back)."""
