"""Plain PyTorch references of the system's answers: point location and
interpolation (``locate.py``) and the field-line tracer (``tracer.py``).
They import nothing of the system under test."""
