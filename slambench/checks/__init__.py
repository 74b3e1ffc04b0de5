"""Checks by name, beyond the common ones of ``check.py``: a cell's
``"checks"`` lists them.  ``<name>.py`` installs the captures it needs
through the driver's probes (``install``) and returns its numbers under
the limit keys the cell bounds (``numbers``)."""
