"""Evaluation tower of the port: LPAPS, CLAP text consistency, FAD and the
score orchestration over the CLIs' results trees.

Counterpart of ``audioeditingcode_tpu/evals``. The metrics are numpy on the
host; the CLAP towers that feed them run on the card
(``features.ClapExtractor``)."""
