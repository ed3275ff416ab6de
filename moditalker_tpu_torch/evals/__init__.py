"""Quality metrics (the part the trainers probe with)."""
