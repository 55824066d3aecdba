"""Small utilities of the port: parameter trees (``utils.tree``)."""
