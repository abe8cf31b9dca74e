"""Optimizer rules of the reference, one module a rule, found by the
configuration's ``training.optimizer``: optax's update equations, times
``-training.learning_rate``."""
