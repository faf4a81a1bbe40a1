"""Measuring tools for the port, run by hand on a GPU machine."""
