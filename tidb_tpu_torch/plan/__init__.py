"""Physical plan nodes the storage path executes (only CopPlan so far)."""
