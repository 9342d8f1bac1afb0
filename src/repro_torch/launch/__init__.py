"""Launch entry points: mine.py (the mining CLI), serve.py (LM serving),
train.py (LM training)."""
