"""Profiles, dictionary, NFA, event formats and the filtering engines."""
