"""Multi-device serving. Counterpart of `tempo_tpu/parallel/`: this slice
carries only the `mesh:` config block (`serving.MeshConfig`) and
`serving.configure`, which the App calls; mesh serving itself comes with
ROADMAP section 1, item 13."""
