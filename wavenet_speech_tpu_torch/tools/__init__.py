"""Offline tools (wavenet_speech_tpu/tools/): data preparation (reference
utils/dump_distributions.py, utils/dump_durations_from_eventalign.py), the
hyperparameter search over ``cli.train_with_result`` (``bayes_opt``), and
the bisection of a non-finite step's dump (``bisect_nonfinite``)."""
