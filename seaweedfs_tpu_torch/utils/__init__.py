"""Host utilities of the serving stack (task supervision, deadlines)."""
