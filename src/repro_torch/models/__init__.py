"""The paper's small FL models."""
