"""Launch entry points: mine.py (the mining CLI)."""
