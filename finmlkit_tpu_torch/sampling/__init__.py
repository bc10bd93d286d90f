"""Event sampling filters."""
