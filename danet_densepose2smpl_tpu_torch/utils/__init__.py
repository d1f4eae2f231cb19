"""Visualization for the demo and the training summaries (numpy; no cv2,
no matplotlib)."""
