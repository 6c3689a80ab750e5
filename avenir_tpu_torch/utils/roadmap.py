"""How a refusal names the later work that ports what it refuses."""

from __future__ import annotations


def roadmap_item(title: str) -> str:
    """A ROADMAP queue A item, named by its title (its number changes when
    the queue is reordered)."""
    return f"ROADMAP queue A, '{title}'"
