"""Host-side video input and output (cv2, imported when first used)."""
