"""Layers and graph builders."""
