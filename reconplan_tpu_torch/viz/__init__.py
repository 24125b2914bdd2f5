"""Headless visualisation: the HTML point-cloud viewer."""
