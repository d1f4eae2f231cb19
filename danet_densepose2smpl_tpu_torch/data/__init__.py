"""Data layer: SPIN-format npz datasets and their augmentation, mixed
sampling, the resumable loaders, image files without cv2, the RLE codec,
DensePose annotations, and synthetic fixtures."""
