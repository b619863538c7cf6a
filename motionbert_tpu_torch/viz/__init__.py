"""Motion rendering (``viz/render.py``)."""
