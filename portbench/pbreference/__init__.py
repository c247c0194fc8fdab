"""The benchmark's plain reference: a frozen copy of the port's model,
scheduler and editing modules with every hand-written kernel replaced by
plain float32 PyTorch (``ops/flash_attention.py``, ``ops/swiglu.py``), and
the precision knob of the controls (``precision.py``).

It imports nothing of the port and nothing of JAX. It takes the weights,
clips and draws that the benchmark makes, never what the port derived from
them.
"""
