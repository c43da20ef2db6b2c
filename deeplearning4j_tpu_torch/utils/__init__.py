"""Helpers shared by the fit loops."""
