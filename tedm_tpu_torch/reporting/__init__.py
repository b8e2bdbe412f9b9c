"""Reporting: paper tables, significance tests and figures from the eval
CLIs' ``*_predictions.npz`` files (port of ``tedm_tpu/reporting``;
reference: auxiliary/notebooks_and_reporting/). numpy only at import:
scipy and matplotlib are imported by the functions that use them."""
